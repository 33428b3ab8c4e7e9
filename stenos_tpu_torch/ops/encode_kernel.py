"""Block-codec encode of whole superblocks: the CUDA kernel and its plain
torch version.

encode_superblocks(data, bpp, block_level) is the wrapper: a CUDA tensor
goes through csrc/encode_blocks.cu (it replaces the TPU kernel
stenos_tpu/ops/encode_pallas.py::make_encode_kernel); a CPU tensor goes
through encode_superblocks_plain, the torch twin of
stenos_tpu/engine_jax.py::encode_superblocks_body. Both return

  streams (n_sb, W) uint8  block streams, front-packed (the plain version
                           zero-pads them; on the card, a view of rows of
                           the stream bound, unwritten past totals)
  totals  (n_sb,) int32    stream length (no 4-byte record header)
  bsizes  (n_sb, nb) int32 compressed size per block
  fsizes  (n_sb, nb) int32 sum of plane sizes per block (LZ candidacy)

on the input's device. Only streams[i, :totals[i]] is part of the contract.

encode_superblocks_index(data, bpp, block_level, rows_width) is the index
mode of the same kernel (it replaces make_encode_kernel with
with_index=True): whole frame records and the decode index that
decode_kernel.decode_rows_derive reads. Its plain version is
encode_superblocks_index_plain.

encode_superblocks_records(data, bpp, block_level) is the streams mode's
launch writing whole records [1, csize u24, stream] instead (the JAX
package's encode_slabs_body rows), with no index and no device-to-host
copy: the sharded encode's rows (parallel/).

encode_superblocks_frame(data, bpp, block_level, header) writes the records
back to back behind a frame header, in one buffer (the device frame
compress), in one launch of the same kernel: each CTA zeroes its slot of
the frame's capacity, encodes its record into a staging row, finds the
record's place by a decoupled look-back over the sizes of the records
before it and copies it there. Its plain version is
encode_superblocks_frame_plain. place_records(rows, totals, header, nb,
bpp) builds the same frame from record rows made elsewhere (the gathered
mesh frame), in a launch of its own that zeroes the tail too.

encode_superblocks_frames(data, bpp, block_level, header, n_frames) is a
batch of such frames, one a row, in one launch of the same kernel: the
superblocks of n_frames frames of equal length, each frame's records
behind its own header in its own row (the look-back stops at the frame's
first superblock). Its plain version is encode_superblocks_frames_plain.

encode_column_frame(data, bpp, block_level, header, sb) is the frame of a
1-D column whose length is no whole number of superblocks: K1's frame mode
with one more row, the short superblock's whole blocks, placed as any
other record; encode_short (one CTA) appends its partial segment there, in
the frame. Its plain version is encode_column_frame_plain.

launch_plan gives the kernel's shared-memory geometry for a bpp. Every K1
launch goes through a launch descriptor (_descriptor), built once for each
(device, instantiation, bpp, nb) and cached: the plan, the kernel's
shared-memory attribute set on that device, and the frame mode's lag. A
launch then reads the current stream and enqueues K1 (after the memset of
the look-back state in frame mode), nothing else.
"""

import ctypes
import functools
import threading

import torch

from ..codec.analyze import analyze_planes_torch, plane_kinds_torch
from ..codec.emit import (block_header_bytes_torch, encode_partial_torch,
                          partial_bound, plane_sections_torch)
from ..constants import BLOCK_PARTIAL
from ..utils import trace
from . import _cuda
from .compact import compact

# launches of encode_superblocks and place_records below (chip_smoke.py
# reads these): K1's modes (streams, records, frame) and place_records, and
# the index mode (K1b), counted apart; launches_frame_placed counts the
# frame-mode K1 launches, each of which zeroes the frame's capacity and
# places its own records (also counted in launches); launches_frames
# counts the launches for a batch of frames (also counted in launches, not
# in launches_frame_placed); launches_short counts encode_short's;
# descriptor_builds counts the launch descriptors built (the misses of
# their cache, one a new key: launches less it are hits)
launches = 0
launches_index = 0
launches_frame_placed = 0
launches_frames = 0
launches_short = 0
descriptor_builds = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_ULL = ctypes.c_ulonglong
_SIGNATURES = {
    "stenos_encode_prepare": [_P, _I],
    "stenos_encode_superblocks": [_P, _P, _LL, _I, _I, _I, _I, _P, _LL, _I,
                                  _P, _P, _P, _P, _P, _LL, _I, _ULL, _ULL,
                                  _P, _P, _I, _LL, _P],
    "stenos_encode_short": [_P, _I, _I, _P, _P, _P, _P],
    "stenos_place_records": [_P, _LL, _P, _LL, _P, _LL, _ULL, _ULL, _I, _P,
                             _P],
}

SMEM_LIMIT = 232448  # shared memory a CTA can use on Hopper
TILE_BYTES = 8192    # input bytes a tile aims to stage
STAGE_MAX = 16384    # the widest block staged whole; wider go by plane groups
MAX_TILE = 64        # blocks a tile, at most (kMaxTile in the kernel)


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def launch_plan(bpp: int, nb: int) -> dict:
    """Shared-memory geometry of the encode kernel for one superblock of nb
    blocks of bpp bytes per element.

    A block of at most STAGE_MAX bytes is staged whole: a tile of
    tile_blocks blocks, two stage buffers (cp.async double buffering), each
    element-major with `pad` bytes after every 16 elements (16 when bpp is
    even, none when odd: either way a row's 16 elements span an odd number
    of 16-byte words, so the 16 rows of a plane start on 8 distinct banks,
    two rows a bank). tile_blocks is the count (at most nb, MAX_TILE and
    STAGE_MAX bytes) whose planes fill the 16-plane steps best, the
    nearest to TILE_BYTES among equals. A wider block goes by groups of 16
    planes (tile_blocks 0): one stage of 256 elements x 16 bytes. Then the
    output window (a tile's largest output and 15 bytes of phase) and the
    plane codes. Returns tile_blocks, pad, stage_bytes, win_off, codes_off and
    smem (total bytes)."""
    hdr_w = (bpp + 1) // 2
    blk = 256 * bpp
    if blk <= STAGE_MAX:
        def fill(k):
            return k * bpp / (16 * -(-k * bpp // 16))
        kb = max(range(1, min(nb, MAX_TILE, STAGE_MAX // blk) + 1),
                 key=lambda k: (round(fill(k), 9), -abs(k * blk - TILE_BYTES)))
        pad = 16 if bpp % 2 == 0 else 0
        stage = kb * 16 * (16 * bpp + pad)
        n_stage, win = 2, _up16(15 + kb * (hdr_w + blk))
        n_codes = kb * bpp
    else:
        kb, pad = 0, 16
        stage = 16 * (16 * 16 + pad)
        n_stage, win = 1, _up16(15 + 16 * 256)
        n_codes = bpp
    win_off = n_stage * stage
    codes_off = win_off + win
    return {"tile_blocks": kb, "pad": pad, "stage_bytes": stage,
            "win_off": win_off, "codes_off": codes_off,
            "smem": codes_off + _up16(n_codes)}


# K1's instantiations (kind in csrc/encode_blocks.cu's Descriptor): the
# streams, records and index modes; frame mode; frame mode of a column;
# frame mode of a batch of frames
_ROWS, _FRAME, _COLUMN, _FRAMES = 0, 1, 2, 3


class _Descriptor(ctypes.Structure):
    """csrc/encode_blocks.cu's Descriptor: an instantiation's launch plan
    and, once prepared, its lag (the CTAs resident at once)."""
    _fields_ = [("kind", _I), ("tile_blocks", _I), ("pad", _I),
                ("stage_bytes", _I), ("win_off", _I), ("codes_off", _I),
                ("smem", _I), ("lag", _LL)]


# (device index, kind, bpp, nb) -> (descriptor, its address)
_descriptors = {}
_descriptors_lock = threading.Lock()


def _prepare(desc, idx: int) -> None:
    """stenos_encode_prepare on CUDA device idx: its instantiation's
    shared-memory attribute set there, its lag filled in."""
    lib = _cuda.load("encode_blocks", _SIGNATURES)
    with torch.cuda.device(idx):
        _cuda.check(lib.stenos_encode_prepare(ctypes.addressof(desc), idx),
                    "encode_superblocks: prepare")


def _descriptor(idx: int, kind: int, bpp: int, nb: int):
    """The launch descriptor of instantiation kind for superblocks of nb
    blocks of bpp bytes on CUDA device idx, built and prepared on its key's
    first use (a miss, counted in descriptor_builds) and cached: (the
    descriptor, its address). Threads that miss together build it once."""
    global descriptor_builds
    key = (idx, kind, bpp, nb)
    with _descriptors_lock:
        got = _descriptors.get(key)
        if got is None:
            plan = launch_plan(bpp, nb)
            if plan["smem"] > SMEM_LIMIT:
                raise ValueError(f"encode_superblocks: bpp {bpp} needs "
                                 f"{plan['smem']} bytes of shared memory")
            desc = _Descriptor(kind, plan["tile_blocks"], plan["pad"],
                               plan["stage_bytes"], plan["win_off"],
                               plan["codes_off"], plan["smem"], 0)
            _prepare(desc, idx)
            got = _descriptors[key] = (desc, ctypes.addressof(desc))
            descriptor_builds += 1
    return got


SCRATCH_ALIGN = 256  # each region of the frame mode's scratch starts at one


@functools.lru_cache(maxsize=256)
def scratch_layout(n_sb: int, row_w: int, nb: int) -> tuple:
    """Byte offsets of the frame mode's staging in its one scratch buffer:
    rows (n_sb rows of row_w bytes), totals (n_sb int32), bsizes and fsizes
    (n_sb x nb int32 each) and the look-back status (n_sb + 1 int64: a
    word a superblock, then the ticket), each region at a multiple of
    SCRATCH_ALIGN bytes (the status words want 8, the sizes 4). Returns
    (rows, totals, bsizes, fsizes, status, the buffer's bytes)."""
    offsets, end = [], 0
    for n in (n_sb * row_w, 4 * n_sb, 4 * n_sb * nb, 4 * n_sb * nb,
              8 * (n_sb + 1)):
        offsets.append(end)
        end += -(-n // SCRATCH_ALIGN) * SCRATCH_ALIGN
    return (*offsets, end)


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


def place_records_plain(rows, totals, header: bytes, nb: int, bpp: int):
    """Plain torch version of place_records: the records rows[i, :totals[i]
    + 4] (totals count the streams only) taken row by row behind the header,
    zero-padded to the frame's capacity."""
    n_sb = rows.shape[0]
    keep = (torch.arange(rows.shape[1], device=rows.device)
            < (totals + 4)[:, None])
    body = rows[keep]  # row-major: the records in order
    cap = len(header) + n_sb * record_bound(nb, bpp)
    frame = torch.zeros(cap, dtype=torch.uint8, device=rows.device)
    frame[:len(header)] = torch.tensor(list(header), dtype=torch.uint8)
    frame[len(header):len(header) + len(body)] = body
    return frame, (totals + 4).sum(dtype=torch.int64) + len(header)


def frames_stride(n_sb: int, nb: int, bpp: int, hlen: int) -> int:
    """Bytes of a batch's row for frames of n_sb superblocks of nb blocks
    behind an hlen-byte header: the frame's capacity, hlen + n_sb *
    record_bound(nb, bpp), rounded up to a multiple of 16."""
    return _up16(hlen + n_sb * record_bound(nb, bpp))


def encode_superblocks_frames_plain(data, bpp: int, block_level: int,
                                    header: bytes, n_frames: int):
    """Plain torch version of encode_superblocks_frames: the index mode's
    records of every superblock, then each frame's placed behind the header
    by place_records_plain into its row (under the span of the one launch
    it stands for)."""
    per = data.shape[0] // n_frames
    nb = data.shape[1] // (256 * bpp)
    stride = frames_stride(per, nb, bpp, len(header))
    out = torch.zeros((n_frames, stride), dtype=torch.uint8,
                      device=data.device)
    lengths = torch.empty(n_frames, dtype=torch.int64, device=data.device)
    with trace.span("stn.k1.launch", nbytes=data.numel(),
                    superblocks=data.shape[0]):
        rows, totals = encode_superblocks_index_plain(data, bpp,
                                                      block_level)[:2]
        for f in range(n_frames):
            frame, lengths[f] = place_records_plain(
                rows[f * per : (f + 1) * per],
                totals[f * per : (f + 1) * per] - 4, header, nb, bpp)
            out[f, : frame.numel()] = frame
    return out, lengths


def encode_superblocks_frame_plain(data, bpp: int, block_level: int,
                                   header: bytes, spare: int = 0):
    """Plain torch version of the frame layout: the index mode's records
    placed behind the header by place_records_plain (under the span of the
    one launch it stands for), spare zeros more."""
    with trace.span("stn.k1.launch", nbytes=data.numel(),
                    superblocks=data.shape[0]):
        rows, totals = encode_superblocks_index_plain(data, bpp,
                                                      block_level)[:2]
        frame, length = place_records_plain(
            rows, totals - 4, header, data.shape[1] // (256 * bpp), bpp)
    return torch.cat([frame, frame.new_zeros(spare)]), length


def column_slot(nb: int, r: int, bpp: int) -> int:
    """A column frame's bytes of capacity a superblock: the record bound
    of a whole superblock of nb blocks (nb 0 for a column shorter than
    one) or, if longer, of the short superblock of r bytes (its whole
    blocks, the 0xFE marker and the partial segment)."""
    nbs, rbytes = divmod(r, 256 * bpp)
    short = record_bound(nbs, bpp) + (1 + partial_bound(rbytes, bpp)
                                      if rbytes else 0)
    return max(record_bound(nb, bpp), short)


def encode_column_frame_plain(data, bpp: int, block_level: int,
                              header: bytes, sb: int):
    """Plain torch version of encode_column_frame (each step under the span
    of the launch it stands for)."""
    nbytes = data.numel()
    n_full, r = divmod(nbytes, sb)
    blk = 256 * bpp
    nbs, rbytes = divmod(r, blk)
    dev = data.device
    parts = [torch.tensor(list(header), dtype=torch.uint8, device=dev)]
    stream = torch.zeros(0, dtype=torch.uint8, device=dev)
    with trace.span("stn.k1.launch", nbytes=n_full * sb + nbs * blk,
                    superblocks=n_full + 1):
        # K1 places every record, the short superblock's whole blocks too
        if n_full:
            rows, totals = encode_superblocks_index_plain(
                data[: n_full * sb].view(n_full, sb), bpp, block_level)[:2]
            parts.append(rows[torch.arange(rows.shape[1], device=dev)
                              < totals[:, None]])
        if nbs:
            streams, total = encode_superblocks_plain(
                data[n_full * sb : n_full * sb + nbs * blk].view(1, -1), bpp,
                block_level)[:2]
            stream = streams[0, : int(total[0])]
    with trace.span("stn.short_superblock", nbytes=rbytes, superblocks=1):
        if rbytes:
            seg, n = encode_partial_torch(data[nbytes - rbytes :], bpp)
            stream = torch.cat([stream, stream.new_full((1,), BLOCK_PARTIAL),
                                seg[: int(n)]])
    n = stream.numel()
    parts += [torch.tensor([1, n & 255, (n >> 8) & 255, n >> 16],
                           dtype=torch.uint8, device=dev), stream]
    body = torch.cat(parts)
    slot = column_slot(sb // blk if n_full else 0, r, bpp)
    frame = body.new_zeros(len(header) + (n_full + 1) * slot)
    frame[: body.numel()] = body
    return frame, torch.tensor(body.numel(), dtype=torch.int64)


def _check_args(name, data, bpp, block_level):
    if data.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {data.device}")
    if (data.dtype != torch.uint8 or data.dim() != 2
            or not data.is_contiguous()):
        raise ValueError(f"{name}: need contiguous (n_sb, sbytes) uint8")
    if (bpp < 1 or data.shape[1] % (256 * bpp) or 0 in data.shape
            or not 0 <= block_level <= 2):
        raise ValueError(f"{name}: bad shape {tuple(data.shape)} for bpp "
                         f"{bpp}, block level {block_level}")


def _launch(data, kind: int, bpp: int, block_level: int, n_sb: int,
            nb: int, nb_last: int, row_w: int, rec: int, rows: int,
            totals: int, bsizes: int, fsizes: int, plane_off: int = 0,
            frame: int = 0, cap: int = 0, header: bytes = b"",
            length: int = 0, status: int = 0, per: int = 0,
            stride: int = 0) -> None:
    """One launch of encode_superblocks (K1) through the cached descriptor
    of instantiation kind, on the current stream of data's device (read on
    every call, so that a caller's torch.cuda.stream holds). rows ..
    status are device addresses (0: none): plane_off only in index mode,
    frame (cap bytes behind the header), length and status only in frame
    mode; per and stride (superblocks a frame, bytes a frame's row) only
    for a batch of frames, where length holds n_sb / per lengths."""
    if data.data_ptr() % 16:  # the kernel copies 16-byte words
        data = data.clone()
    idx = data.get_device()
    desc = (_descriptors.get((idx, kind, bpp, nb))
            or _descriptor(idx, kind, bpp, nb))
    h = header.ljust(16, b"\0")
    lib = _cuda.load("encode_blocks", _SIGNATURES)
    with trace.span("stn.k1.launch", data.device,
                    nbytes=((n_sb - 1) * nb + nb_last) * 256 * bpp,
                    superblocks=n_sb):
        _cuda.check(lib.stenos_encode_superblocks(
            desc[1], data.data_ptr(), n_sb, nb, nb_last, bpp, block_level,
            rows, row_w, rec, totals, bsizes, fsizes, plane_off, frame, cap,
            len(header), int.from_bytes(h[:8], "little"),
            int.from_bytes(h[8:], "little"), length, status, per, stride,
            torch._C._cuda_getCurrentRawStream(idx)), "encode_superblocks")


def _encode_rows(data, bpp: int, block_level: int, row_w: int, rec: int,
                 index: bool):
    """One launch of encode_superblocks in the streams (rec 0), records
    (rec 4) or index mode (index, rec 4: zeros after each record up to
    row_w, and the decode index): each superblock's stream or record [1,
    csize u24, stream] at the start of its row of row_w bytes. Returns
    (rows, stream totals, bsizes, fsizes, plane_off or None), each a tensor
    of its own: the callers keep them, and apart."""
    global launches, launches_index
    n_sb, sbytes = data.shape
    nb = sbytes // (256 * bpp)
    dev = data.device
    rows = torch.empty((n_sb, row_w), dtype=torch.uint8, device=dev)
    totals = torch.empty(n_sb, dtype=torch.int32, device=dev)
    bsizes = torch.empty((n_sb, nb), dtype=torch.int32, device=dev)
    fsizes = torch.empty((n_sb, nb), dtype=torch.int32, device=dev)
    plane_off = (torch.empty((n_sb, bpp * nb), dtype=torch.int32, device=dev)
                 if index else None)
    _launch(data, _ROWS, bpp, block_level, n_sb, nb, nb, row_w, rec,
            rows.data_ptr(), totals.data_ptr(), bsizes.data_ptr(),
            fsizes.data_ptr(), plane_off.data_ptr() if index else 0)
    if index:
        launches_index += 1
    else:
        launches += 1
    return rows, totals, bsizes, fsizes, plane_off


def _frame(data, bpp: int, block_level: int, header: bytes, slot: int,
           spare: int = 0, column=None):
    """The device frame's launches: K1 in frame mode into a new frame of
    len(header) + n_sb * slot bytes of capacity (slot at least a record
    bound) and spare bytes more, zeroed apart. A column (a 1-D data, column
    = (n_sb, nb, nb_last): n_sb - 1 superblocks of nb blocks, then the
    short superblock's nb_last whole blocks) takes K1's column
    instantiation, then, under the span stn.short_superblock, encode_short
    for the bytes past those blocks, if any. K1's staging (rows of slot
    bytes, the sizes and the look-back state) is one scratch buffer
    (scratch_layout), freed to the stream after the launches. Returns
    (frame, length 0-d int64)."""
    global launches, launches_frame_placed, launches_short
    if len(header) > 16:
        raise ValueError("encode_superblocks_frame: header longer than 16")
    if column is None:
        kind = _FRAME
        n_sb, sbytes = data.shape
        nb = nb_last = sbytes // (256 * bpp)
    else:
        kind = _COLUMN
        n_sb, nb, nb_last = column
    dev = data.device
    cap = len(header) + n_sb * slot
    frame = torch.empty(cap + spare, dtype=torch.uint8, device=dev)
    if spare:
        frame[cap:].zero_()
    length = torch.empty((), dtype=torch.int64, device=dev)
    lay = scratch_layout(n_sb, slot, nb)
    scratch = torch.empty(lay[5], dtype=torch.uint8, device=dev)
    at = scratch.data_ptr()
    _launch(data, kind, bpp, block_level, n_sb, nb, nb_last, slot, 4,
            at + lay[0], at + lay[1], at + lay[2], at + lay[3], 0,
            frame.data_ptr(), cap, header, length.data_ptr(), at + lay[4])
    launches += 1
    launches_frame_placed += 1
    if column is not None:
        rbytes = data.numel() - ((n_sb - 1) * nb + nb_last) * 256 * bpp
        with trace.span("stn.short_superblock", dev, nbytes=rbytes,
                        superblocks=1):
            if rbytes:
                lib = _cuda.load("encode_blocks", _SIGNATURES)
                _cuda.check(lib.stenos_encode_short(
                    data.data_ptr() + data.numel() - rbytes, rbytes, bpp,
                    frame.data_ptr(), length.data_ptr(),
                    at + lay[1] + 4 * (n_sb - 1),
                    torch._C._cuda_getCurrentRawStream(data.get_device())),
                    "encode_short")
                launches_short += 1
    return frame, length


def _frames(data, bpp: int, block_level: int, header: bytes,
            n_frames: int):
    """A batch of device frames in one launch of K1's batch instantiation:
    data's rows are the superblocks of n_frames frames in order, frame f
    goes to row f of a new (n_frames, frames_stride) tensor, zeroed past
    its length by the kernel. K1's staging is one scratch buffer, as for
    one frame. Returns (out, lengths (n_frames,) int64)."""
    global launches, launches_frames
    n_sb, sbytes = data.shape
    per = n_sb // n_frames
    nb = sbytes // (256 * bpp)
    slot = record_bound(nb, bpp)
    stride = frames_stride(per, nb, bpp, len(header))
    dev = data.device
    out = torch.empty((n_frames, stride), dtype=torch.uint8, device=dev)
    lengths = torch.empty(n_frames, dtype=torch.int64, device=dev)
    lay = scratch_layout(n_sb, slot, nb)
    scratch = torch.empty(lay[5], dtype=torch.uint8, device=dev)
    at = scratch.data_ptr()
    _launch(data, _FRAMES, bpp, block_level, n_sb, nb, nb, slot, 4,
            at + lay[0], at + lay[1], at + lay[2], at + lay[3], 0,
            out.data_ptr(), len(header) + per * slot, header,
            lengths.data_ptr(), at + lay[4], per, stride)
    launches += 1
    launches_frames += 1
    return out, lengths


def encode_superblocks(data, bpp: int, block_level: int):
    """The wrapper: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor (see the module docstring for the outputs)."""
    if data.device.type == "cpu":
        with trace.span("stn.k1.launch", nbytes=data.numel(),
                        superblocks=data.shape[0]):
            return encode_superblocks_plain(data, bpp, block_level)
    _check_args("encode_superblocks", data, bpp, block_level)
    nb = data.shape[1] // (256 * bpp)
    rows, totals, bsizes, fsizes = _encode_rows(
        data, bpp, block_level, record_bound(nb, bpp) - 4, 0, False)[:4]
    # the streams as wide as the longest (one device-to-host read): a view
    # of the stream-bound rows; no reader looks past totals, so no zeros
    return rows[:, :max(int(totals.max()), 1)], totals, bsizes, fsizes


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
    rows, stream_totals, bsizes, fsizes, plane_off = _encode_rows(
        data, bpp, block_level, rows_width or record_bound(nb, bpp), 4, True)
    totals = stream_totals + 4
    if rows_width is None:  # cut to the longest record: a copy
        rows = rows[:, :int(totals.max())].contiguous()
    return rows, totals, bsizes, fsizes, plane_off


def encode_superblocks_records(data, bpp: int, block_level: int):
    """The records wrapper: one launch of K1 (counted as K1) writing each
    superblock's record [1, csize u24, stream] at the start of its row of
    record_bound(nb, bpp) bytes, with no device-to-host copy; on a CPU
    tensor the index mode's plain version without its index, rows as wide.
    Returns (rows, totals, bsizes, fsizes): rows[i, :totals[i]] is the
    record (totals count the 4 header bytes); bytes past it are not part of
    the contract (zeros in the plain version, unwritten on the card)."""
    nb = data.shape[1] // (256 * bpp) if bpp > 0 else 0
    if data.device.type == "cpu":
        return encode_superblocks_index_plain(data, bpp, block_level,
                                              record_bound(nb, bpp))[:4]
    _check_args("encode_superblocks_records", data, bpp, block_level)
    rows, totals, bsizes, fsizes = _encode_rows(
        data, bpp, block_level, record_bound(nb, bpp), 4, False)[:4]
    return rows, totals + 4, bsizes, fsizes


def place_records(rows, totals, header: bytes, nb: int, bpp: int):
    """The records of rows (rows[i, :totals[i] + 4], totals counting the
    streams only) back to back behind header, zeros to the capacity
    len(header) + n_sb * record_bound(nb, bpp), in one launch of its own
    (counted as K1): the frame of record rows made elsewhere (the gathered
    mesh frame). A CPU tensor takes place_records_plain. Returns (frame,
    length 0-d int64)."""
    global launches
    if rows.device.type == "cpu":
        return place_records_plain(rows, totals, header, nb, bpp)
    if (rows.device.type != "cuda" or rows.dtype != torch.uint8
            or rows.dim() != 2 or not rows.is_contiguous()
            or totals.dtype != torch.int32 or totals.device != rows.device
            or tuple(totals.shape) != rows.shape[:1]):
        raise ValueError("place_records: need contiguous (n_sb, W) uint8 "
                         "rows and (n_sb,) int32 totals on one CUDA device")
    if len(header) > 16:
        raise ValueError("place_records: header longer than 16")
    lib = _cuda.load("encode_blocks", _SIGNATURES)
    dev = rows.device
    n_sb = rows.shape[0]
    frame = torch.empty(len(header) + n_sb * record_bound(nb, bpp),
                        dtype=torch.uint8, device=dev)
    length = torch.empty((), dtype=torch.int64, device=dev)
    h = header.ljust(16, b"\0")
    with trace.span("stn.place_records.launch", dev, superblocks=n_sb):
        _cuda.check(lib.stenos_place_records(
            rows.data_ptr(), rows.shape[1], totals.data_ptr(), n_sb,
            frame.data_ptr(), frame.numel(), int.from_bytes(h[:8], "little"),
            int.from_bytes(h[8:], "little"), len(header), length.data_ptr(),
            torch._C._cuda_getCurrentRawStream(rows.get_device())),
            "place_records")
    launches += 1
    return frame, length


def encode_superblocks_frame(data, bpp: int, block_level: int,
                             header: bytes, spare: int = 0):
    """The frame-layout wrapper: every superblock's record [1, csize u24,
    stream] back to back behind `header`, in one buffer, with no
    device-to-host copy. Returns (frame (capacity,) uint8, length 0-d int64
    tensor): the frame is frame[:length], zeros follow; capacity is
    len(header) + n_sb * record_bound(nb, bpp), and spare bytes more
    (zeroed apart, for a record the caller adds). One K1 launch (counted
    as K1): it zeroes the capacity behind the header and writes the
    header, the records and the length over it."""
    if data.device.type == "cpu":
        return encode_superblocks_frame_plain(data, bpp, block_level, header,
                                              spare)
    _check_args("encode_superblocks_frame", data, bpp, block_level)
    nb = data.shape[1] // (256 * bpp)
    return _frame(data, bpp, block_level, header, record_bound(nb, bpp),
                  spare)


def encode_column_frame(data, bpp: int, block_level: int, header: bytes,
                        sb: int):
    """The frame of a 1-D uint8 column whose length is no whole number of
    superblocks of sb bytes, every superblock a METHOD_BLOCK record behind
    header: the whole superblocks as encode_superblocks_frame writes them,
    then the short superblock's record [1, csize u24, its whole blocks'
    stream, 0xFE, the partial segment of the bytes past them]
    (codec/encode_np.py's block_codec_encode without LZ). Returns (frame
    (capacity,) uint8, length 0-d int64): the frame is frame[:length], zeros
    follow; capacity is len(header) + (n_sb + 1) * column_slot(nb, r, bpp)
    for n_sb whole superblocks of nb blocks (nb 0 when n_sb is 0) and r
    bytes past them.

    On the card, with no device-to-host copy: K1 in frame mode, the short
    superblock's whole blocks a last row of their own, placed as any other
    record; encode_short (one CTA, under the span stn.short_superblock)
    appends the partial segment in the frame. A CPU tensor takes
    encode_column_frame_plain."""
    if data.device.type == "cpu":
        return encode_column_frame_plain(data, bpp, block_level, header, sb)
    nbytes = data.numel()
    if (data.device.type != "cuda" or data.dtype != torch.uint8
            or data.dim() != 1 or not data.is_contiguous() or bpp < 1
            or sb % (256 * bpp) or not nbytes % sb
            or not 0 <= block_level <= 2 or len(header) > 16):
        raise ValueError(f"encode_column_frame: need a contiguous 1-D uint8 "
                         f"CUDA column of no whole number of {sb}-byte "
                         f"superblocks for bpp {bpp}, block level "
                         f"{block_level}")
    n_full, r = divmod(nbytes, sb)
    nb = sb // (256 * bpp)
    return _frame(data, bpp, block_level, header,
                  column_slot(nb if n_full else 0, r, bpp), column=(
                      n_full + 1, nb, r // (256 * bpp)))


def encode_superblocks_frames(data, bpp: int, block_level: int,
                              header: bytes, n_frames: int):
    """A batch of device frames: data's rows are the superblocks of
    n_frames frames of data.shape[0] / n_frames superblocks each, in order,
    and frame f is every record of its superblocks [1, csize u24, stream]
    back to back behind `header`. Returns (out (n_frames, stride) uint8,
    lengths (n_frames,) int64 tensor): frame f is out[f, :lengths[f]],
    zeros follow; stride is frames_stride. No device-to-host copy. One K1
    launch of its batch instantiation (counted as K1 and in
    launches_frames); with n_frames 1, row 0 is encode_superblocks_frame's
    frame and zeros to a multiple of 16 bytes. A CPU tensor takes
    encode_superblocks_frames_plain."""
    if not (n_frames > 0 and data.dim() == 2
            and data.shape[0] % n_frames == 0):
        raise ValueError(f"encode_superblocks_frames: {tuple(data.shape)} "
                         f"is no whole number of superblocks a frame for "
                         f"{n_frames} frames")
    if len(header) > 16:
        raise ValueError("encode_superblocks_frames: header longer than 16")
    if data.device.type == "cpu":
        return encode_superblocks_frames_plain(data, bpp, block_level,
                                               header, n_frames)
    _check_args("encode_superblocks_frames", data, bpp, block_level)
    return _frames(data, bpp, block_level, header, n_frames)
