"""Block-codec row decode of whole superblocks: the CUDA kernel and its plain
torch version.

decode_rows(vbufs, plane_off, rowtab, bpp, nb) is the wrapper: CUDA tensors
go through csrc/decode_rows.cu (it replaces the TPU kernel
stenos_tpu/ops/decode_pallas.py::make_decode_kernel, explicit row-record
mode); CPU tensors go through decode_rows_plain, the torch twin of
stenos_tpu/engine_jax.py::_decode_rows_body. Inputs are the native batched
parser's output (native.parse_rows_batch):

  vbufs     (n_sb, row_bytes) uint8  virtual streams (LZ/COPY inlined)
  plane_off (n_sb, P) int32          plane start (low 24 bits)
  rowtab    (n_sb, 16, P) int32      rel | hdr<<10 | min<<14 per row

with P = nb*bpp in stream order (p = block*bpp + plane). Both return the
decoded superblocks as (n_sb, nb*256*bpp) uint8 in natural byte order.

decode_rows_derive(vbufs, plane_off, bpp, nb, plane_order) is the derive
mode of the same kernel (it replaces make_decode_kernel with derive=True):
plane_off carries off | code << 24 and no rowtab exists; the records come
from the stream's own header bytes. plane_order is 'jb' (p = plane*nb +
block, encode_kernel.encode_superblocks_index's index) or 'bj' (the parser's
order). Its plain version is decode_rows_derive_plain, which derives a
rowtab (derive_rowtab_plain) and calls decode_rows_plain.
"""

import ctypes
import functools

import torch

from . import _cuda
from .bitpack import unpack16_torch

# kernel launches (chip_smoke.py reads these): explicit records (K2) and
# derive mode (K2b), counted apart
launches = 0
launches_derive = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_GEOMETRY = [_I] * 7  # launch_plan's tile_blocks .. smem
_SIGNATURES = {
    "stenos_decode_rows": [_P, _LL, _P, _P, _LL, _I, _I, *_GEOMETRY, _P, _P],
    "stenos_decode_rows_derive": [_P, _LL, _P, _LL, _I, _I, _I, *_GEOMETRY,
                                  _P, _P],
}
_WIN = 320  # plane window of the derivation: offset-chain reads end < 298

SMEM_LIMIT = 232448  # shared memory a CTA can use on Hopper
OUT_MAX = 16384      # a tile's output bytes, at most
TILE_BYTES = 16384   # a tile's output bytes, aimed at
TARGET_CTAS = 264    # CTAs a call should have: two an SM on an H100
PLANE_BYTES = 264    # a plane's stream bytes, staged room for (ALL_RAW: 256)


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def launch_plan(bpp: int, nb: int, n_sb: int = 1) -> dict:
    """Tiles and CTA width of the decode kernel for n_sb superblocks of nb
    blocks of bpp bytes per element.

    A tile is tile_blocks whole blocks of one superblock (every plane of
    them), its output one contiguous span of at most OUT_MAX bytes. The CTA
    has `slots` half-warps, so a step decodes `slots` planes in (block,
    plane) order, one lane a row. For each width (16, 8, 4, 2 half-warps)
    the tile is the one whose last step is fullest, then that gives the
    most CTAs (up to TARGET_CTAS), then the nearest to TILE_BYTES; the
    widest CTA that makes TARGET_CTAS CTAs is taken, else the one that makes
    the most. A block wider than OUT_MAX goes by groups of `group` planes
    (tile_blocks 0), 16 half-warps. Returns tile_blocks, group, tiles (a
    superblock), threads, stage (staged stream bytes), out_bytes (the
    largest tile's output), plane_off_bytes (its plane offsets),
    rowtab_bytes (K2's row records) and smem, in the kernel's order."""
    hdr_w = (bpp + 1) // 2
    blk = 256 * bpp
    if blk > OUT_MAX:
        group = OUT_MAX // 256
        kb, slots, planes = 0, 16, group
        tiles = nb * -(-bpp // group)
        stage = _up16(group * PLANE_BYTES + 48)
    else:
        def fill(k, s):
            return k * bpp / (s * -(-k * bpp // s))

        def ctas(k):
            return n_sb * -(-nb // k)

        best = []
        for s in (16, 8, 4, 2):
            k = max(range(1, min(nb, OUT_MAX // blk) + 1),
                    key=lambda k: (round(fill(k, s), 9),
                                   min(ctas(k), TARGET_CTAS),
                                   -abs(k * blk - TILE_BYTES)))
            best.append((s, k))
        wide = [c for c in best if ctas(c[1]) >= TARGET_CTAS]
        slots, kb = wide[0] if wide else max(best, key=lambda c: (ctas(c[1]),
                                                                   c[0]))
        group, planes = 0, kb * bpp
        tiles = -(-nb // kb)
        stage = _up16(planes * PLANE_BYTES + kb * hdr_w + 48)
    out = 256 * planes
    po = 4 * (-(-planes // 4) * 4)
    rt = 16 * (planes | 1) * 4
    return {"tile_blocks": kb, "group": group, "tiles": tiles,
            "threads": 16 * slots, "stage": stage, "out_bytes": out,
            "plane_off_bytes": po, "rowtab_bytes": rt,
            "smem": stage + out + po + rt}


@functools.lru_cache(maxsize=256)
def _launch_args(bpp: int, nb: int, n_sb: int, derive: bool):
    p = launch_plan(bpp, nb, n_sb)
    smem = p["smem"] - (p["rowtab_bytes"] if derive else 0)
    return (p["tile_blocks"], p["group"], p["tiles"], p["threads"],
            p["stage"], p["out_bytes"], smem)


def decode_rows_plain(vbufs, plane_off, rowtab, bpp: int, nb: int):
    """Plain torch version (see the module docstring)."""
    n_sb, row_bytes = vbufs.shape
    dev = vbufs.device
    i32 = torch.int32
    P = nb * bpp
    rt = rowtab.to(i32).transpose(1, 2)  # (n_sb, P, 16)
    h = ((rt >> 10) & 15).reshape(-1)
    mins = ((rt >> 14) & 255).reshape(-1, 1)

    # each row's 18-byte window; reads past the stream see zeros
    start = (plane_off.to(torch.int64) & 0xFFFFFF)[..., None] + (rt & 1023)
    idx = start[..., None] + torch.arange(18, device=dev)
    idx = idx.clamp(max=row_bytes).reshape(n_sb, -1)
    padded = torch.cat([vbufs, torch.zeros((n_sb, 1), dtype=torch.uint8,
                                           device=dev)], 1)
    W = torch.gather(padded, 1, idx).to(i32).reshape(-1, 18)  # (R, 18)

    # RLE rows (6/7): mask bit set = repeat; literal k is byte 2 + k. Lane c
    # holds the latest literal at or before c (fill-left), 0 before the first.
    cpos = torch.arange(16, device=dev)
    lit = (((W[:, 0] | (W[:, 1] << 8))[:, None] >> cpos) & 1) == 0
    litc = torch.cumsum(lit.to(i32), -1)
    rle_vals = torch.where(litc > 0,
                           torch.gather(W, 1, (1 + litc).long().clamp(max=17)),
                           0)
    rle_bflag = (litc == 0).to(i32)

    # bit-packed rows (1-5, 9-14); headers 0 and 8 carry no bits
    bitpack = ((h >= 1) & (h <= 5)) | ((h >= 9) & (h <= 14))
    bwidth = torch.where(bitpack, h % 8, 0)
    vals = torch.zeros((W.shape[0], 16), dtype=i32, device=dev)
    for b in range(1, 7):
        sel = bwidth == b
        vals[sel] = unpack16_torch(W[sel, : 2 * b], b)

    h2 = h[:, None]
    direct_a = (vals + mins) & 255
    delta_a = torch.cumsum(vals + mins, -1) & 255
    drle_a = torch.cumsum(rle_vals, -1) & 255
    a = torch.where(h2 == 15, W[:, :16], direct_a)
    a = torch.where((h2 >= 8) & (h2 <= 14), delta_a, a)
    a = torch.where(h2 == 6, drle_a, a)
    a = torch.where(h2 == 7, rle_vals, a)
    bflag = torch.zeros_like(a)
    bflag = torch.where((h2 >= 6) & (h2 <= 14) & (h2 != 7), 1, bflag)
    bflag = torch.where(h2 == 7, rle_bflag, bflag)

    # cross-row carry: out = a + bflag * previous row's last byte (mod 256)
    a = a.to(i32).reshape(n_sb, P, 16, 16)
    bflag = bflag.to(i32).reshape(n_sb, P, 16, 16)
    prev = torch.zeros((n_sb, P), dtype=i32, device=dev)
    rows = []
    for r in range(16):
        row = (a[:, :, r] + bflag[:, :, r] * prev[..., None]) & 255
        rows.append(row)
        prev = row[..., 15]
    planes = torch.stack(rows, 2).reshape(n_sb, nb, bpp, 256)
    return planes.transpose(2, 3).reshape(n_sb, nb * 256 * bpp).to(torch.uint8)


def _popcount16(m):
    return ((m[..., None] >> torch.arange(16, device=m.device)) & 1).sum(-1)


def derive_rowtab_plain(vbufs, plane_off, bpp: int, nb: int,
                        plane_order: str):
    """Row records from the stream's own bytes, in torch ops (the JAX
    package's decode_pallas.derive_records). Returns (plane_off, rowtab) in
    'bj' order, as decode_rows_plain takes them."""
    n_sb, row_bytes = vbufs.shape
    dev = vbufs.device
    P = nb * bpp
    po = plane_off.to(torch.int32)
    if plane_order == "jb":
        po = po.reshape(n_sb, bpp, nb).transpose(1, 2).reshape(n_sb, P)
    elif plane_order != "bj":
        raise ValueError(f"plane_order must be 'jb' or 'bj', not "
                         f"{plane_order!r}")
    code = ((po >> 24) & 3)[..., None]  # (n_sb, P, 1)
    idx = ((po & 0xFFFFFF).long()[..., None]
           + torch.arange(_WIN, device=dev)).clamp(max=row_bytes)
    padded = torch.cat([vbufs, torch.zeros((n_sb, 1), dtype=torch.uint8,
                                           device=dev)], 1)
    w = torch.gather(padded, 1, idx.reshape(n_sb, -1)).reshape(
        n_sb, P, _WIN).to(torch.int32)

    def at(k):  # window bytes at per-row positions k (n_sb, P, m)
        return torch.gather(w, 2, k.long())

    hb = w[..., :8]
    nib = torch.stack([hb & 15, hb >> 4], -1).reshape(n_sb, P, 16)
    el = ((nib != 6) & (nib != 7) & (nib != 15)).to(torch.int32)
    el_excl = torch.cumsum(el, -1) - el
    mins_plain = torch.where(el == 1, at(8 + el_excl), 0)
    r16 = torch.arange(16, device=dev)
    lit = (((w[..., 8:9] | (w[..., 9:10] << 8)) >> r16) & 1) == 0
    litc = torch.cumsum(lit.to(torch.int32), -1)  # literals at or before r
    mins_rle = torch.where(litc > 0, at(9 + litc), 0)
    mins = torch.where(code == 3, mins_rle, mins_plain)
    minv = torch.where(code == 0, w[..., 0:1], torch.where(code == 1, 0, mins))
    hdr = torch.where(code == 0, 0, torch.where(code == 1, 15, nib))

    size = torch.where(nib == 15, 16,
                       torch.where(nib >= 8, 2 * (nib - 8), 2 * nib))
    is_rle = (nib == 6) | (nib == 7)
    rel = torch.where(code == 3, 10 + litc[..., 15:16],
                      8 + el.sum(-1, keepdim=True))
    rels = []
    for r in range(16):
        rels.append(rel)
        mask = at(rel) | (at(rel + 1) << 8)
        rel = rel + torch.where(is_rle[..., r:r + 1], 18 - _popcount16(mask),
                                size[..., r:r + 1])
    rel = torch.where(code == 0, 1,
                      torch.where(code == 1, 16 * r16, torch.cat(rels, -1)))
    rowtab = (rel | (hdr << 10) | (minv << 14)).to(torch.int32)
    return po, rowtab.transpose(1, 2).contiguous()


def decode_rows_derive_plain(vbufs, plane_off, bpp: int, nb: int,
                             plane_order: str):
    """Plain torch version of the derive mode (see the module docstring)."""
    po, rowtab = derive_rowtab_plain(vbufs, plane_off, bpp, nb, plane_order)
    return decode_rows_plain(vbufs, po, rowtab, bpp, nb)


def decode_rows(vbufs, plane_off, rowtab, bpp: int, nb: int):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring)."""
    if vbufs.device.type == "cpu":
        return decode_rows_plain(vbufs, plane_off, rowtab, bpp, nb)
    if vbufs.device.type != "cuda":
        raise ValueError(f"decode_rows: unsupported device {vbufs.device}")
    n_sb, row_bytes = vbufs.shape
    P = nb * bpp
    for t, dt, shape in ((vbufs, torch.uint8, (n_sb, row_bytes)),
                         (plane_off, torch.int32, (n_sb, P)),
                         (rowtab, torch.int32, (n_sb, 16, P))):
        if (t.device != vbufs.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError("decode_rows: need contiguous vbufs (n_sb, L) "
                             "uint8, plane_off (n_sb, P) and rowtab "
                             f"(n_sb, 16, P) int32 on one device, P = {P}")
    global launches
    out = torch.empty((n_sb, nb * 256 * bpp), dtype=torch.uint8,
                      device=vbufs.device)
    if n_sb == 0:
        return out
    lib = _cuda.load("decode_rows", _SIGNATURES)
    stream = torch.cuda.current_stream(vbufs.device).cuda_stream
    _cuda.check(lib.stenos_decode_rows(
        vbufs.data_ptr(), row_bytes, plane_off.data_ptr(), rowtab.data_ptr(),
        n_sb, nb, bpp, *_launch_args(bpp, nb, n_sb, False), out.data_ptr(),
        stream), "decode_rows")
    launches += 1
    return out


def decode_rows_derive(vbufs, plane_off, bpp: int, nb: int,
                       plane_order: str):
    """The derive-mode wrapper (K2b): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see the module docstring). The kernel
    reads only the bytes the index points at, within each row of vbufs."""
    if plane_order not in ("jb", "bj"):
        raise ValueError(f"plane_order must be 'jb' or 'bj', not "
                         f"{plane_order!r}")
    if vbufs.device.type == "cpu":
        return decode_rows_derive_plain(vbufs, plane_off, bpp, nb,
                                        plane_order)
    if vbufs.device.type != "cuda":
        raise ValueError(f"decode_rows_derive: unsupported device "
                         f"{vbufs.device}")
    n_sb, row_bytes = vbufs.shape
    P = nb * bpp
    for t, dt, shape in ((vbufs, torch.uint8, (n_sb, row_bytes)),
                         (plane_off, torch.int32, (n_sb, P))):
        if (t.device != vbufs.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError("decode_rows_derive: need contiguous vbufs "
                             "(n_sb, L) uint8 and plane_off (n_sb, P) int32 "
                             f"on one device, P = {P}")
    global launches_derive
    out = torch.empty((n_sb, nb * 256 * bpp), dtype=torch.uint8,
                      device=vbufs.device)
    if n_sb == 0:
        return out
    lib = _cuda.load("decode_rows", _SIGNATURES)
    stream = torch.cuda.current_stream(vbufs.device).cuda_stream
    _cuda.check(lib.stenos_decode_rows_derive(
        vbufs.data_ptr(), row_bytes, plane_off.data_ptr(), n_sb, nb, bpp,
        int(plane_order == "jb"), *_launch_args(bpp, nb, n_sb, True),
        out.data_ptr(), stream), "decode_rows_derive")
    launches_derive += 1
    return out
