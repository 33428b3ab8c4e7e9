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

encode_superblocks_index(data, bpp, block_level, rows_width) is the index
mode of the same kernel (it replaces make_encode_kernel with
with_index=True): whole frame records and the decode index that
decode_kernel.decode_rows_derive reads. Its plain version is
encode_superblocks_index_plain.

encode_superblocks_frame(data, bpp, block_level, header) launches the same
kernel once more in another layout: the records back to back behind a frame
header, in one buffer (the device frame compress). Its plain version is
encode_superblocks_frame_plain.
"""

import ctypes

import torch

from ..codec.analyze import analyze_planes_torch, plane_kinds_torch
from ..codec.emit import block_header_bytes_torch, plane_sections_torch
from . import _cuda
from .compact import compact

# launches of both kernels below (chip_smoke.py reads these): K1's modes
# (streams, frame), and the index mode (K1b), counted apart
launches = 0
launches_index = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "stenos_encode_planes": [_P, _LL, _I, _I, _P, _P, _P, _P],
    "stenos_assemble_blocks": [_P, _P, _P, _P, _LL, _I, _P, _I, _P, _P, _P,
                               _P],
}


def encode_superblocks_plain(data, bpp: int, block_level: int):
    """Plain torch version. data: (n_sb, sbytes) uint8, sbytes % (256*bpp)
    == 0. Lays every section out at its padded slot with a validity mask,
    then compacts each superblock's row."""
    return _encode_plain(data, bpp, block_level)[:4]


def _encode_plain(data, bpp: int, block_level: int):
    """encode_superblocks_plain's outputs, then the per-plane emitted sizes
    and plane codes (n_sb, nb, bpp) that the decode index is built from."""
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
    return (out.to(torch.uint8), total, block_sizes, full_sizes, plane_sizes,
            codes)


def record_bound(nb: int, bpp: int) -> int:
    """Longest record [1, csize u24, stream] nb blocks can give: a block is
    at most hdr_w + 256*bpp bytes (a NORMAL plane larger than its target is
    demoted to 256 raw bytes)."""
    return 4 + nb * ((bpp + 1) // 2 + 256 * bpp)


def _fit(t, width: int):
    """Rows of t cut or zero-padded to width (bytes past totals are zero)."""
    if t.shape[1] >= width:
        return t[:, :width].contiguous()
    pad = torch.zeros((t.shape[0], width - t.shape[1]), dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad], 1)


def encode_superblocks_index_plain(data, bpp: int, block_level: int,
                                   rows_width=None):
    """Plain torch version of the index mode: encode_superblocks_plain's
    streams behind a 4-byte record header, and the decode index from
    exclusive sums of the emitted block and plane sizes."""
    streams, total, bsizes, fsizes, plane_sizes, codes = _encode_plain(
        data, bpp, block_level)
    n_sb, nb = bsizes.shape
    hdr_w = (bpp + 1) // 2
    hdr4 = torch.stack([torch.ones_like(total), total & 255,
                        (total >> 8) & 255, (total >> 16) & 255], -1)
    totals = total + 4
    width = rows_width if rows_width is not None else int(totals.max())
    rows = _fit(torch.cat([hdr4.to(torch.uint8), streams], -1), width)
    pl_excl = torch.cumsum(plane_sizes, -1, dtype=torch.int32) - plane_sizes
    b_excl = torch.cumsum(bsizes, -1, dtype=torch.int32) - bsizes
    off = 4 + b_excl[..., None] + hdr_w + pl_excl
    plane_off = (off | (codes << 24)).transpose(1, 2).reshape(n_sb, bpp * nb)
    return rows, totals, bsizes, fsizes, plane_off.to(torch.int32)


def encode_superblocks_frame_plain(data, bpp: int, block_level: int,
                                   header: bytes):
    """Plain torch version of the frame layout: the index mode's records
    (rows[i, :totals[i]]) taken row by row behind the header, zero-padded to
    the frame's capacity."""
    n_sb, sbytes = data.shape
    rows, totals, _, _, _ = encode_superblocks_index_plain(data, bpp,
                                                           block_level)
    keep = torch.arange(rows.shape[1], device=data.device) < totals[:, None]
    body = rows[keep]  # row-major: the records in order
    cap = len(header) + n_sb * record_bound(sbytes // (256 * bpp), bpp)
    frame = torch.zeros(cap, dtype=torch.uint8, device=data.device)
    frame[:len(header)] = torch.tensor(list(header), dtype=torch.uint8)
    frame[len(header):len(header) + len(body)] = body
    return frame, totals.sum(dtype=torch.int64) + len(header)


def _check_args(name, data, bpp, block_level):
    if data.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {data.device}")
    if (data.dtype != torch.uint8 or data.dim() != 2
            or not data.is_contiguous()):
        raise ValueError(f"{name}: need contiguous (n_sb, sbytes) uint8")
    if (bpp < 1 or data.shape[1] % (256 * bpp)
            or not 0 <= block_level <= 2):
        raise ValueError(f"{name}: bad shape {tuple(data.shape)} for bpp "
                         f"{bpp}, block level {block_level}")


def _count(index: bool):
    global launches, launches_index
    if index:
        launches_index += 1
    else:
        launches += 1


def _launch(data, bpp: int, block_level: int, mode: str, rows_width=None,
            header=b""):
    """Both launches of one mode, each counted. mode "streams" (K1): returns
    (streams, stream totals, bsizes, fsizes); "index" (K1b): (rows, stream
    totals, bsizes, fsizes, plane_off); "frame": (frame, length)."""
    lib = _cuda.load("encode_blocks", _SIGNATURES)
    dev = data.device
    n_sb, sbytes = data.shape
    nb = sbytes // (256 * bpp)
    n_blocks = n_sb * nb
    hdr_w = (bpp + 1) // 2
    index = mode == "index"
    stream = torch.cuda.current_stream(dev).cuda_stream
    slots = torch.empty(n_blocks * bpp * 256, dtype=torch.uint8, device=dev)
    psizes = torch.empty(n_blocks * bpp, dtype=torch.int32, device=dev)
    codes = torch.empty(n_blocks * bpp, dtype=torch.int32, device=dev)
    _cuda.check(lib.stenos_encode_planes(
        data.data_ptr(), n_blocks, bpp, block_level, slots.data_ptr(),
        psizes.data_ptr(), codes.data_ptr(), stream), "encode_planes")
    _count(index)

    fsizes = psizes.view(n_sb, nb, bpp).sum(-1, dtype=torch.int32)
    bsizes = fsizes + hdr_w
    totals = bsizes.sum(-1, dtype=torch.int32)
    starts = torch.cumsum(bsizes, -1, dtype=torch.int64) - bsizes
    sb_idx = torch.arange(n_sb, dtype=torch.int64, device=dev)
    rec_base = plane_off = None
    if mode == "frame":
        # records back to back behind the header: no device-to-host copy
        rec_len = totals.to(torch.int64) + 4
        rec_base = len(header) + torch.cumsum(rec_len, 0) - rec_len
        out = torch.zeros(len(header) + n_sb * record_bound(nb, bpp),
                          dtype=torch.uint8, device=dev)
        out[:len(header)] = torch.tensor(list(header), dtype=torch.uint8)
    else:
        # rows_width given: no device-to-host copy (the caller checked it
        # against record_bound); else one read of the longest stream
        width = rows_width or max(int(totals.max()) + 4 * index, 1)
        out = torch.zeros((n_sb, width), dtype=torch.uint8, device=dev)
        if index:
            rec_base = width * sb_idx
            plane_off = torch.empty((n_sb, bpp * nb), dtype=torch.int32,
                                    device=dev)
    base = starts + (rec_base[:, None] + 4 if rec_base is not None
                     else width * sb_idx[:, None])
    _cuda.check(lib.stenos_assemble_blocks(
        slots.data_ptr(), psizes.data_ptr(), codes.data_ptr(),
        base.data_ptr(), n_blocks, bpp, out.data_ptr(), nb,
        totals.data_ptr() if rec_base is not None else None,
        rec_base.data_ptr() if rec_base is not None else None,
        plane_off.data_ptr() if index else None, stream), "assemble_blocks")
    _count(index)
    if mode == "frame":
        return out, rec_len.sum() + len(header)
    if index:
        return out, totals, bsizes, fsizes, plane_off
    return out, totals, bsizes, fsizes


def encode_superblocks(data, bpp: int, block_level: int):
    """The wrapper: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor (see the module docstring for the outputs)."""
    if data.device.type == "cpu":
        return encode_superblocks_plain(data, bpp, block_level)
    _check_args("encode_superblocks", data, bpp, block_level)
    return _launch(data, bpp, block_level, "streams")


def encode_superblocks_index(data, bpp: int, block_level: int,
                             rows_width=None):
    """The index-mode wrapper (K1b), the contract of the JAX package's
    encode_slabs_index_body. Returns (rows, totals, bsizes, fsizes,
    plane_off): rows[i, :totals[i]] is the whole record [1, csize u24,
    stream] (totals count the 4 header bytes); plane_off (n_sb, bpp*nb)
    int32 is (4 + block start + hdr_w + plane start) | code << 24 in 'jb'
    order (p = plane*nb + block).

    rows_width=None sizes rows by the longest record (one device-to-host
    read); a width of at least record_bound(nb, bpp) makes no such read."""
    nb = data.shape[1] // (256 * bpp) if bpp > 0 else 0
    if rows_width is not None and rows_width < record_bound(nb, bpp):
        raise ValueError(f"encode_superblocks_index: rows_width {rows_width} "
                         f"is below the record bound {record_bound(nb, bpp)}")
    if data.device.type == "cpu":
        return encode_superblocks_index_plain(data, bpp, block_level,
                                              rows_width)
    _check_args("encode_superblocks_index", data, bpp, block_level)
    rows, stream_totals, bsizes, fsizes, plane_off = _launch(
        data, bpp, block_level, "index", rows_width)
    return rows, stream_totals + 4, bsizes, fsizes, plane_off


def encode_superblocks_frame(data, bpp: int, block_level: int,
                             header: bytes):
    """The frame-layout wrapper: every superblock's record [1, csize u24,
    stream] back to back behind `header`, in one buffer, with no
    device-to-host copy. Returns (frame (capacity,) uint8, length 0-d int64
    tensor): the frame is frame[:length], zeros follow; capacity is
    len(header) + n_sb * record_bound(nb, bpp). Counted as K1 launches."""
    if data.device.type == "cpu":
        return encode_superblocks_frame_plain(data, bpp, block_level, header)
    _check_args("encode_superblocks_frame", data, bpp, block_level)
    return _launch(data, bpp, block_level, "frame", header=header)
