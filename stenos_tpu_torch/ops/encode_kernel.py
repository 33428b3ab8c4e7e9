"""Block-codec encode of whole superblocks: the CUDA kernel and its plain
torch version.

encode_superblocks(data, bpp, block_level) is the wrapper: a CUDA tensor
goes through csrc/encode_blocks.cu (it replaces the TPU kernel
stenos_tpu/ops/encode_pallas.py::make_encode_kernel); a CPU tensor goes
through encode_superblocks_plain, the torch twin of
stenos_tpu/engine_jax.py::encode_superblocks_body. Both return

  streams (n_sb, W) uint8  block streams, front-packed, zero-padded
  totals  (n_sb,) int32    stream length (no 4-byte record header)
  bsizes  (n_sb, nb) int32 compressed size per block
  fsizes  (n_sb, nb) int32 sum of plane sizes per block (LZ candidacy)

on the input's device. Only streams[i, :totals[i]] is part of the contract.
"""

import ctypes

import torch

from ..codec.analyze import analyze_planes_torch, plane_kinds_torch
from ..codec.emit import block_header_bytes_torch, plane_sections_torch
from . import _cuda
from .compact import compact

launches = 0  # launches of both kernels below (chip_smoke.py reads this)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "stenos_encode_planes": [_P, _LL, _I, _I, _P, _P, _P, _P],
    "stenos_assemble_blocks": [_P, _P, _P, _P, _LL, _I, _P, _P],
}


def encode_superblocks_plain(data, bpp: int, block_level: int):
    """Plain torch version. data: (n_sb, sbytes) uint8, sbytes % (256*bpp)
    == 0. Lays every section out at its padded slot with a validity mask,
    then compacts each superblock's row."""
    n_sb, sbytes = data.shape
    dev = data.device
    nb = sbytes // (256 * bpp)
    hdr_w = (bpp + 1) // 2
    hdr_pad = 8 if hdr_w <= 8 else ((hdr_w + 7) // 8) * 8
    i32 = torch.int32

    el = data.reshape(n_sb, nb, 256, bpp).to(i32)
    x = el.transpose(2, 3).reshape(n_sb, nb, bpp, 16, 16)
    firsts = el[:, :, 0, :]

    info = analyze_planes_torch(x, firsts, block_level >= 1)
    codes, psizes = plane_kinds_torch(info, block_level)
    full_sizes = psizes.sum(-1, dtype=i32)

    sec = plane_sections_torch(x, info, codes, firsts)
    bhdr = block_header_bytes_torch(codes, bpp)

    # RAW planes re-use the 16 row slots as 16 raw 16-byte chunks
    is_raw = (codes == 1)[..., None]
    rows = torch.where(
        is_raw[..., None],
        torch.cat([x, torch.zeros(x.shape[:-1] + (2,), dtype=i32, device=dev)],
                  -1),
        sec["rows"])
    lenR = torch.where(is_raw, 16, sec["lenR"])
    lenA = torch.where(is_raw[..., 0], 0, sec["lenA"])
    lenB = torch.where(is_raw[..., 0], 0, sec["lenB"])

    # padded per-block layout: [bhdr(hdr_pad) | per plane: A(8) B(18) 16x18]
    plane_w = 8 + 18 + 16 * 18
    bhdr_pad = torch.cat(
        [bhdr, torch.zeros((n_sb, nb, hdr_pad - hdr_w), dtype=i32, device=dev)],
        -1)
    planes_flat = torch.cat(
        [sec["headA"], sec["minsec"], rows.reshape(*rows.shape[:-2], 288)], -1)
    layout = torch.cat(
        [bhdr_pad, planes_flat.reshape(n_sb, nb, bpp * plane_w)], -1
    ).reshape(n_sb, nb * (hdr_pad + bpp * plane_w))

    def sec_mask(width, lens):
        return torch.arange(width, dtype=i32, device=dev) < lens[..., None]

    m_bhdr = sec_mask(hdr_pad, torch.full((n_sb, nb), hdr_w, dtype=i32,
                                          device=dev))
    m_planes = torch.cat([sec_mask(8, lenA), sec_mask(18, lenB),
                          sec_mask(18, lenR).reshape(*lenR.shape[:-1], 288)],
                         -1)
    valid = torch.cat(
        [m_bhdr, m_planes.reshape(n_sb, nb, bpp * plane_w)], -1
    ).reshape(layout.shape)

    out, total = compact(layout, valid)
    plane_sizes = lenA + lenB + lenR.sum(-1, dtype=i32)
    block_sizes = hdr_w + plane_sizes.sum(-1, dtype=i32)
    return out.to(torch.uint8), total, block_sizes, full_sizes


def encode_superblocks(data, bpp: int, block_level: int):
    """The wrapper: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor (see the module docstring for the outputs)."""
    if data.device.type == "cpu":
        return encode_superblocks_plain(data, bpp, block_level)
    if data.device.type != "cuda":
        raise ValueError(f"encode_superblocks: unsupported device "
                         f"{data.device}")
    if (data.dtype != torch.uint8 or data.dim() != 2
            or not data.is_contiguous()):
        raise ValueError("encode_superblocks: need contiguous (n_sb, sbytes) "
                         "uint8")
    n_sb, sbytes = data.shape
    if bpp < 1 or sbytes % (256 * bpp) or not 0 <= block_level <= 2:
        raise ValueError(f"encode_superblocks: bad shape {tuple(data.shape)} "
                         f"for bpp {bpp}, block level {block_level}")
    lib = _cuda.load("encode_blocks", _SIGNATURES)
    global launches
    dev = data.device
    nb = sbytes // (256 * bpp)
    n_blocks = n_sb * nb
    hdr_w = (bpp + 1) // 2
    stream = torch.cuda.current_stream(dev).cuda_stream
    slots = torch.empty(n_blocks * bpp * 256, dtype=torch.uint8, device=dev)
    psizes = torch.empty(n_blocks * bpp, dtype=torch.int32, device=dev)
    codes = torch.empty(n_blocks * bpp, dtype=torch.int32, device=dev)
    _cuda.check(lib.stenos_encode_planes(
        data.data_ptr(), n_blocks, bpp, block_level, slots.data_ptr(),
        psizes.data_ptr(), codes.data_ptr(), stream), "encode_planes")
    launches += 1

    fsizes = psizes.view(n_sb, nb, bpp).sum(-1, dtype=torch.int32)
    bsizes = fsizes + hdr_w
    totals = bsizes.sum(-1, dtype=torch.int32)
    width = max(int(totals.max()), 1)
    starts = torch.cumsum(bsizes, -1, dtype=torch.int64) - bsizes
    base = starts + width * torch.arange(n_sb, device=dev)[:, None]
    streams = torch.zeros((n_sb, width), dtype=torch.uint8, device=dev)
    _cuda.check(lib.stenos_assemble_blocks(
        slots.data_ptr(), psizes.data_ptr(), codes.data_ptr(),
        base.data_ptr(), n_blocks, bpp, streams.data_ptr(), stream),
        "assemble_blocks")
    launches += 1
    return streams, totals, bsizes, fsizes
