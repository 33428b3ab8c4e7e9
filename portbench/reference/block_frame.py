"""Plain PyTorch reference of a stenos frame whose every superblock is a
METHOD_BLOCK record: the block codec's encode (per-plane analysis, plane
codes, section emission, compaction) and the frame around it.

A frozen copy, for the benchmark's own use, of the plain torch version of
the port's block encode: stenos_tpu_torch/codec/analyze.py
(analyze_planes_torch, plane_kinds_torch), codec/emit.py
(plane_sections_torch, block_header_bytes_torch, compact16_torch,
mask16_torch), ops/bitpack.py (pack16_torch, pack16_any_torch),
ops/compact.py (compact) and ops/encode_kernel.py (_encode_plain,
encode_superblocks_index_plain, place_records_plain), as of the commit
that added this file. Those follow the C++ stenos library's
find_pack_bits_params and encode16x16_generic (block_compress.h:385-806).
It imports nothing of the port, so a change to the port cannot move it.

Every function takes and returns torch tensors on any device; all integer
math is int32 with explicit mod-256 wraps.
"""

import numpy as np
import torch

I32 = torch.int32
STENOS_BLOCK_SIZE = 131072
RAW_DIFF = (25, 16, 0)  # a plane goes ALL_RAW above 256 - diff[block level]


def _width_lut():
    # bit length, with 7 bumped to 8 (block_compress.h:334-352)
    w = np.zeros(256, dtype=np.int32)
    for v in range(1, 256):
        w[v] = v.bit_length()
    w[w == 7] = 8
    return w


_WIDTH_LUT = _width_lut()


def _as_int8(v):
    return ((v + 128) & 255) - 128


def analyze_planes(x, first, has_rle):
    """Per-plane analysis. x: (..., 16, 16) int32 plane bytes (a plane is
    one byte position across a block's 256 elements); first: (...,) the
    first element's byte of each plane."""
    x = x.to(I32)
    flat = x.reshape(x.shape[:-2] + (256,))
    prev = torch.cat([torch.zeros_like(flat[..., :1]), flat[..., :-1]], -1)
    prev = prev.reshape(x.shape)
    d = (x - prev) & 255

    xs, ds = _as_int8(x), _as_int8(d)
    mn, mnd = xs.amin(-1), ds.amin(-1)
    rng, rng_d = xs.amax(-1) - mn, ds.amax(-1) - mnd

    lut = torch.as_tensor(_WIDTH_LUT, device=x.device)
    bits0 = lut[rng.long()]
    bits0 = torch.where(bits0 == 6, 8, bits0)  # header 6 is delta-RLE's
    bits1 = lut[rng_d.long()]
    bits = torch.minimum(bits0, bits1)
    t0 = bits0 == bits  # direct wins ties
    minbytes = torch.where(t0, mn, mnd) & 255
    sizes = 2 * bits + (bits != 8).to(I32)

    eq = x == prev
    dprev = torch.cat([torch.zeros_like(d[..., :1]), d[..., :-1]], -1)
    deq = d == dprev

    if has_rle:
        rle_size = 16 - eq.sum(-1, dtype=I32) + 2
        use_rle = rle_size < sizes
        sizes = torch.minimum(sizes, rle_size)
        drle_size = 16 - deq.sum(-1, dtype=I32) + 2
        use_drle = drle_size < sizes
        sizes = torch.minimum(sizes, drle_size)
    else:
        use_rle = torch.zeros(bits.shape, dtype=torch.bool, device=x.device)
        use_drle = use_rle
    all_rle = use_rle | use_drle

    h_direct = torch.where(bits0 == 8, 15, bits0)
    h_delta = torch.where(bits1 == 8, 7, bits1) + 8
    headers = torch.where(t0, h_direct, h_delta)
    headers = torch.where(use_rle & ~use_drle, 7, headers)
    headers = torch.where(use_drle, 6, headers)

    all_same = (x == first[..., None, None]).flatten(-2).all(-1)

    mprev = torch.cat([torch.zeros_like(minbytes[..., :1]),
                       minbytes[..., :-1]], -1)
    meq = minbytes == mprev
    if has_rle:
        bits_8 = (~all_rle) & (bits == 8)
        count8 = bits_8.sum(-1, dtype=I32) + all_rle.sum(-1, dtype=I32)
        mins_rle_size = 16 - meq.sum(-1, dtype=I32) + 2
        normal_rle = mins_rle_size < (16 - count8)
        plane_size = (8 + sizes.sum(-1, dtype=I32)
                      - torch.where(normal_rle,
                                    (16 - count8) - mins_rle_size, 0))
        sizes = sizes - (normal_rle[..., None] & ~bits_8 & ~all_rle).to(I32)
    else:
        normal_rle = torch.zeros(all_same.shape, dtype=torch.bool,
                                 device=x.device)
        plane_size = 8 + sizes.sum(-1, dtype=I32)

    return {"headers": headers, "minbytes": minbytes, "row_sizes": sizes,
            "deltas": d, "eq": eq, "deq": deq, "meq": meq,
            "all_same": all_same, "normal_rle": normal_rle,
            "plane_size": plane_size}


def plane_kinds(info, block_level):
    """Plane codes (0 ALL_SAME, 1 ALL_RAW, 2 NORMAL, 3 NORMAL_RLE) after
    the ALL_RAW demotion (block_compress.h:1190-1206)."""
    target = 256 - RAW_DIFF[block_level]
    all_same = info["all_same"]
    raw = (~all_same) & (info["plane_size"] > target)
    codes = torch.where(all_same, 0,
                        torch.where(raw, 1,
                                    torch.where(info["normal_rle"], 3, 2)))
    return codes.to(I32)


def _pack_maps(b):
    # output byte k of 2*b (group k // b, byte k % b), bit m: value j =
    # group*8 + bit // b, its bit bit % b (write_16, block_compress.h:562)
    ks, ms = np.arange(2 * b), np.arange(8)
    bit = (ks % b)[:, None] * 8 + ms[None, :]
    return (ks // b)[:, None] * 8 + bit // b, bit % b


def pack16(values, b):
    """(..., 16) int32 values at b bits -> (..., 2*b) bytes."""
    j, p = _pack_maps(b)
    dev = values.device
    bits = (values[..., torch.as_tensor(j, device=dev)]
            >> torch.as_tensor(p, dtype=I32, device=dev)) & 1
    weights = 1 << torch.arange(8, dtype=I32, device=dev)
    return (bits * weights).sum(-1, dtype=I32)


def pack16_any(values, bits):
    """(..., 16) values at per-row widths -> (..., 12), zero rows where the
    width is not in 1..6."""
    out = torch.zeros(values.shape[:-1] + (12,), dtype=I32,
                      device=values.device)
    for b in range(1, 7):
        out[..., : 2 * b] = torch.where((bits == b)[..., None],
                                        pack16(values, b), out[..., : 2 * b])
    return out


def _compact16(rows, keep):
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    return torch.gather(rows, -1, order)


def _mask16(eq):
    w = 1 << torch.arange(16, dtype=I32, device=eq.device)
    return (eq.to(I32) * w).sum(-1, dtype=I32)


def plane_sections(x, info, codes, firsts):
    """Each plane's sections: headA/lenA (row headers, the ALL_SAME byte),
    minsec/lenB (the row minimums), rows/lenR (the 16 rows)."""
    dev = x.device
    h = info["headers"]
    normal = (codes == 2) | (codes == 3)

    hdr8 = h[..., 0::2] | (h[..., 1::2] << 4)
    first_col = torch.cat(
        [firsts[..., None],
         torch.zeros(hdr8.shape[:-1] + (7,), dtype=I32, device=dev)], -1)
    headA = torch.where((codes == 0)[..., None], first_col, hdr8)
    lenA = torch.where(codes == 0, 1, torch.where(normal, 8, 0))

    eligible = (h != 6) & (h != 7) & (h != 15)
    mins = info["minbytes"]
    zeros2 = torch.zeros(mins.shape[:-1] + (2,), dtype=I32, device=dev)
    plainB = torch.cat([_compact16(mins, eligible), zeros2], -1)
    n_eligible = eligible.sum(-1, dtype=I32)

    meq = info["meq"]
    mmask = _mask16(meq)
    rleB = torch.cat([(mmask & 255)[..., None], (mmask >> 8)[..., None],
                      _compact16(mins, ~meq)], -1)
    n_kept = (~meq).sum(-1, dtype=I32)

    is_rle = codes == 3
    minsec = torch.where(is_rle[..., None], rleB, plainB)
    lenB = torch.where(normal, torch.where(is_rle, 2 + n_kept, n_eligible), 0)

    d = info["deltas"]
    bitpack = ((h >= 1) & (h <= 5)) | ((h >= 9) & (h <= 14))
    b = torch.where(bitpack, h % 8, 0)
    sub = torch.where((h < 8)[..., None], x, d)
    v = (sub - mins[..., None]) & 255
    rows = torch.cat([pack16_any(v, b),
                      torch.zeros(h.shape + (6,), dtype=I32, device=dev)], -1)
    lenR = 2 * b

    raw = h == 15
    raw_rows = torch.cat(
        [x, torch.zeros(h.shape + (2,), dtype=I32, device=dev)], -1)
    rows = torch.where(raw[..., None], raw_rows, rows)
    lenR = torch.where(raw, 16, lenR)

    for hh, src, keepmask in ((7, x, info["eq"]), (6, d, info["deq"])):
        sel = h == hh
        m = _mask16(keepmask)
        cand = torch.cat([(m & 255)[..., None], (m >> 8)[..., None],
                          _compact16(src, ~keepmask)], -1)
        rows = torch.where(sel[..., None], cand, rows)
        lenR = torch.where(sel, 2 + (~keepmask).sum(-1, dtype=I32), lenR)

    lenR = torch.where(normal[..., None], lenR, 0)
    return {"headA": headA, "lenA": lenA, "minsec": minsec, "lenB": lenB,
            "rows": rows, "lenR": lenR}


def _compact(values, valid):
    """The valid lanes of (n, W) rows moved to the front, in order; returns
    (rows, counts)."""
    n, width = values.shape
    pos = torch.cumsum(valid.to(I32), -1)
    dest = torch.where(valid, pos - 1, width).long()
    out = torch.zeros((n, width + 1), dtype=I32, device=values.device)
    out.scatter_(1, dest, values.to(I32) & 255)
    return out[:, :width], pos[:, -1].to(I32)


def encode_streams(data, bpp: int, block_level: int):
    """Block streams of whole superblocks. data: (n_sb, sb) uint8, sb a
    multiple of 256 * bpp. Returns (streams (n_sb, W) uint8 zero-padded,
    totals (n_sb,) int32): streams[i, :totals[i]] is superblock i's
    stream."""
    n_sb, sbytes = data.shape
    dev = data.device
    nb = sbytes // (256 * bpp)
    hdr_w = (bpp + 1) // 2
    hdr_pad = 8 if hdr_w <= 8 else ((hdr_w + 7) // 8) * 8

    el = data.reshape(n_sb, nb, 256, bpp).to(I32)
    x = el.transpose(2, 3).reshape(n_sb, nb, bpp, 16, 16)
    firsts = el[:, :, 0, :]

    info = analyze_planes(x, firsts, block_level >= 1)
    codes = plane_kinds(info, block_level)
    sec = plane_sections(x, info, codes, firsts)
    cpad = codes
    if bpp % 2:
        cpad = torch.cat([codes, torch.zeros_like(codes[..., :1])], -1)
    bhdr = cpad[..., 0::2] | (cpad[..., 1::2] << 4)

    # an ALL_RAW plane takes its 16 row slots as 16 raw 16-byte chunks
    is_raw = (codes == 1)[..., None]
    rows = torch.where(
        is_raw[..., None],
        torch.cat([x, torch.zeros(x.shape[:-1] + (2,), dtype=I32,
                                  device=dev)], -1),
        sec["rows"])
    lenR = torch.where(is_raw, 16, sec["lenR"])
    lenA = torch.where(is_raw[..., 0], 0, sec["lenA"])
    lenB = torch.where(is_raw[..., 0], 0, sec["lenB"])

    # padded layout of a block: [header (hdr_pad) | a plane: A(8) B(18) 16x18]
    plane_w = 8 + 18 + 16 * 18
    bhdr_pad = torch.cat(
        [bhdr, torch.zeros((n_sb, nb, hdr_pad - hdr_w), dtype=I32,
                           device=dev)], -1)
    planes = torch.cat(
        [sec["headA"], sec["minsec"], rows.reshape(*rows.shape[:-2], 288)],
        -1)
    layout = torch.cat(
        [bhdr_pad, planes.reshape(n_sb, nb, bpp * plane_w)], -1
    ).reshape(n_sb, nb * (hdr_pad + bpp * plane_w))

    def lanes(width, lens):
        return torch.arange(width, dtype=I32, device=dev) < lens[..., None]

    m_bhdr = lanes(hdr_pad, torch.full((n_sb, nb), hdr_w, dtype=I32,
                                       device=dev))
    m_planes = torch.cat([lanes(8, lenA), lanes(18, lenB),
                          lanes(18, lenR).reshape(*lenR.shape[:-1], 288)], -1)
    valid = torch.cat(
        [m_bhdr, m_planes.reshape(n_sb, nb, bpp * plane_w)], -1
    ).reshape(layout.shape)
    out, totals = _compact(layout, valid)
    return out.to(torch.uint8), totals


def superblock_params(bpp: int, nbytes: int, level: int):
    """(superblock bytes, shift byte) of a standard frame header
    (stenos.cpp:115-169)."""
    block = 256 * bpp
    sb = block if block > STENOS_BLOCK_SIZE else (
        STENOS_BLOCK_SIZE // block) * block
    shift = 0
    if nbytes > sb:
        shift = (level - 1) // 2 if level else 0
        sb <<= shift
    return sb, shift


def frame_header(nbytes: int, bpp: int, level: int) -> bytes:
    """The 8-byte frame header: shift byte, then the size in 7 LE bytes."""
    return bytes([superblock_params(bpp, nbytes, level)[1]]) + \
        nbytes.to_bytes(7, "little")


def block_frame(data, bpp: int, level: int, block_level: int = 2,
                rows_per_step: int = 256):
    """The frame of data ((n_sb, sb) uint8, sb the level's superblock size)
    with every superblock a METHOD_BLOCK record [1, csize u24 LE, stream],
    encoded at block_level, as a 1-D uint8 tensor on data's device.
    Superblocks are encoded rows_per_step at a time, so that the
    intermediates stay a few GiB at most."""
    n_sb, sb = data.shape
    nbytes = n_sb * sb
    if superblock_params(bpp, nbytes, level)[0] != sb:
        raise ValueError(f"superblock of {sb} bytes is not the standard one "
                         f"for bytesoftype {bpp}, level {level}")
    dev = data.device
    parts = [torch.tensor(list(frame_header(nbytes, bpp, level)),
                          dtype=torch.uint8, device=dev)]
    for i in range(0, n_sb, rows_per_step):
        streams, totals = encode_streams(data[i : i + rows_per_step], bpp,
                                         block_level)
        hdr4 = torch.stack([torch.ones_like(totals), totals & 255,
                            (totals >> 8) & 255, (totals >> 16) & 255],
                           -1).to(torch.uint8)
        rec = torch.cat([hdr4, streams], -1)
        keep = (torch.arange(rec.shape[1], device=dev)
                < (totals + 4)[:, None])
        parts.append(rec[keep])
    return torch.cat(parts)
