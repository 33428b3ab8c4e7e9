"""Vectorized per-plane analysis of the stenos block codec.

The array form of the reference's per-row scalar SIMD loop
(`find_pack_bits_params`, block_compress.h:385-535): every plane of every
block of a superblock batch is analyzed at once with array reductions.

analyze_planes/plane_kinds take the array module as `xp` (numpy, for the
host encoder); analyze_planes_torch/plane_kinds_torch are the same math on
torch tensors (the plain version of the encode kernel). All integer math is
int32 with explicit mod-256 wraps.

Shapes: x is (..., 16, 16) uint8-valued int32 (a "plane" = 256 bytes of one
byte position across 256 elements, 16 rows of 16 consecutive bytes).
"""

from ..constants import RAW_DIFF


def _width_lut():
    # bit-length with 7 bumped to 8 (block_compress.h:334-352): index by value
    # 0..255. width(v) = bitlength(v); 7 -> 8.
    import numpy as np

    w = np.zeros(256, dtype=np.int32)
    for v in range(1, 256):
        w[v] = v.bit_length()
    w[w == 7] = 8
    return w


_WIDTH_LUT = _width_lut()


def width_of(xp, v):
    return xp.asarray(_WIDTH_LUT)[v]


def as_int8(v):
    """Reinterpret 0..255 values as signed int8 (still int32 dtype)."""
    return ((v + 128) & 255) - 128


def analyze_planes(xp, x, first, has_rle):
    """Analyze planes; returns a dict of arrays (leading dims preserved).

    x: (..., 16, 16) int32 in 0..255 — the plane bytes.
    first: (...,) int32 — byte of the first element of the block for this
        plane (ALL_SAME reference value).
    has_rle: python bool — block level >= 1 (methods & RLE).

    Returned dict keys (shapes relative to leading dims L = x.shape[:-2]):
      headers    (L, 16)  row headers 0..15
      minbytes   (L, 16)  per-row min byte (mod 256), valid for h not in 6/7/15
      row_sizes  (L, 16)  encoded row size incl. inline min byte
      deltas     (L, 16, 16) the mod-256 delta rows (for emission)
      eq, deq    (L, 16, 16) RLE repeat-bit masks for x-rows / delta-rows
      meq        (L, 16)  repeat bits of the mins vector
      all_same   (L,)     bool
      normal_rle (L,)     bool
      plane_size (L,)     predicted plane payload size (before ALL_RAW demotion)
    """
    i32 = xp.int32
    x = x.astype(i32)

    # prev[r][c] = x[r][c-1], prev[r][0] = x[r-1][15], prev[0][0] = 0
    flat = x.reshape(x.shape[:-2] + (256,))
    prev = xp.concatenate([xp.zeros_like(flat[..., :1]), flat[..., :-1]], axis=-1)
    prev = prev.reshape(x.shape)
    d = (x - prev) & 255

    xs = as_int8(x)
    ds = as_int8(d)
    rng = xp.max(xs, axis=-1) - xp.min(xs, axis=-1)
    rng_d = xp.max(ds, axis=-1) - xp.min(ds, axis=-1)
    mn = xp.min(xs, axis=-1)
    mnd = xp.min(ds, axis=-1)

    bits0 = width_of(xp, rng)
    bits0 = xp.where(bits0 == 6, 8, bits0)  # header 6 reserved for delta-RLE
    bits1 = width_of(xp, rng_d)
    bits = xp.minimum(bits0, bits1)
    t0 = bits0 == bits  # direct wins ties
    minbytes = xp.where(t0, mn, mnd) & 255
    sizes = 2 * bits + (bits != 8).astype(i32)

    # RLE on raw rows (chained prev) and on delta rows (within-row only)
    eq = x == prev
    dprev = xp.concatenate(
        [xp.zeros_like(d[..., :, :1]), d[..., :, :-1]], axis=-1
    )
    deq = d == dprev  # deq[...,0] = (d[...,0] == 0)

    if has_rle:
        rle_size = (16 - xp.sum(eq, axis=-1)).astype(i32) + 2
        use_rle = rle_size < sizes
        sizes = xp.minimum(sizes, rle_size)
        drle_size = (16 - xp.sum(deq, axis=-1)).astype(i32) + 2
        use_drle = drle_size < sizes
        sizes = xp.minimum(sizes, drle_size)
    else:
        use_rle = xp.zeros(bits.shape, dtype=bool)
        use_drle = use_rle
    all_rle = use_rle | use_drle

    # Row headers (block_compress.h:495-503)
    h_direct = xp.where(bits0 == 8, 8, bits0)  # 8 placeholder -> 15 below
    h_direct = xp.where(h_direct == 8, 15, h_direct)
    h_delta = xp.where(bits1 == 8, 7, bits1) + 8  # 8..14, 15
    headers = xp.where(t0, h_direct, h_delta)
    headers = xp.where(use_rle & ~use_drle, 7, headers)
    headers = xp.where(use_drle, 6, headers)

    all_same = xp.all(x == first[..., None, None], axis=(-2, -1))

    # NORMAL_RLE decision over the mins vector (block_compress.h:480-491)
    mprev = xp.concatenate(
        [xp.zeros_like(minbytes[..., :1]), minbytes[..., :-1]], axis=-1
    )
    meq = minbytes == mprev  # meq[...,0] = (min[0] == 0)
    if has_rle:
        bits_8 = (~all_rle) & (bits == 8)
        count8 = xp.sum(bits_8.astype(i32), axis=-1) + xp.sum(
            all_rle.astype(i32), axis=-1
        )
        mins_rle_size = (16 - xp.sum(meq, axis=-1)).astype(i32) + 2
        normal_rle = mins_rle_size < (16 - count8)
        plane_size = (
            8
            + xp.sum(sizes, axis=-1)
            - xp.where(normal_rle, (16 - count8) - mins_rle_size, 0)
        )
        # When NORMAL_RLE, inline min bytes disappear from eligible rows
        sizes = sizes - (
            normal_rle[..., None] & ~bits_8 & ~all_rle
        ).astype(i32)
    else:
        normal_rle = xp.zeros(all_same.shape, dtype=bool)
        plane_size = 8 + xp.sum(sizes, axis=-1)

    return {
        "headers": headers,
        "minbytes": minbytes,
        "row_sizes": sizes,
        "deltas": d,
        "eq": eq,
        "deq": deq,
        "meq": meq,
        "all_same": all_same,
        "normal_rle": normal_rle,
        "plane_size": plane_size,
    }


def plane_kinds(xp, info, block_level):
    """Final plane codes + sizes after ALL_RAW demotion (block_compress.h:1190-1206).

    Returns (codes, plane_sizes): codes in {0,1,2,3}, sizes incl. the demoted
    256-byte raw planes and 1-byte ALL_SAME planes.
    """
    target = 256 - RAW_DIFF[block_level]
    size = info["plane_size"]
    all_same = info["all_same"]
    raw = (~all_same) & (size > target)
    codes = xp.where(
        all_same,
        0,
        xp.where(raw, 1, xp.where(info["normal_rle"], 3, 2)),
    )
    sizes = xp.where(all_same, 1, xp.where(raw, 256, size))
    return codes, sizes


def analyze_planes_torch(x, first, has_rle):
    """torch twin of analyze_planes (same arguments, same dict)."""
    import torch

    i32 = torch.int32
    x = x.to(i32)
    flat = x.reshape(x.shape[:-2] + (256,))
    prev = torch.cat([torch.zeros_like(flat[..., :1]), flat[..., :-1]], -1)
    prev = prev.reshape(x.shape)
    d = (x - prev) & 255

    xs = as_int8(x)
    ds = as_int8(d)
    mn = xs.amin(-1)
    mnd = ds.amin(-1)
    rng = xs.amax(-1) - mn
    rng_d = ds.amax(-1) - mnd

    lut = torch.as_tensor(_WIDTH_LUT, device=x.device)
    bits0 = lut[rng.long()]
    bits0 = torch.where(bits0 == 6, 8, bits0)
    bits1 = lut[rng_d.long()]
    bits = torch.minimum(bits0, bits1)
    t0 = bits0 == bits
    minbytes = torch.where(t0, mn, mnd) & 255
    sizes = 2 * bits + (bits != 8).to(i32)

    eq = x == prev
    dprev = torch.cat([torch.zeros_like(d[..., :1]), d[..., :-1]], -1)
    deq = d == dprev

    if has_rle:
        rle_size = 16 - eq.sum(-1, dtype=i32) + 2
        use_rle = rle_size < sizes
        sizes = torch.minimum(sizes, rle_size)
        drle_size = 16 - deq.sum(-1, dtype=i32) + 2
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
        count8 = bits_8.sum(-1, dtype=i32) + all_rle.sum(-1, dtype=i32)
        mins_rle_size = 16 - meq.sum(-1, dtype=i32) + 2
        normal_rle = mins_rle_size < (16 - count8)
        plane_size = (8 + sizes.sum(-1, dtype=i32)
                      - torch.where(normal_rle,
                                    (16 - count8) - mins_rle_size, 0))
        sizes = sizes - (normal_rle[..., None] & ~bits_8 & ~all_rle).to(i32)
    else:
        normal_rle = torch.zeros(all_same.shape, dtype=torch.bool,
                                 device=x.device)
        plane_size = 8 + sizes.sum(-1, dtype=i32)

    return {
        "headers": headers,
        "minbytes": minbytes,
        "row_sizes": sizes,
        "deltas": d,
        "eq": eq,
        "deq": deq,
        "meq": meq,
        "all_same": all_same,
        "normal_rle": normal_rle,
        "plane_size": plane_size,
    }


def plane_kinds_torch(info, block_level):
    """torch twin of plane_kinds."""
    import torch

    target = 256 - RAW_DIFF[block_level]
    size = info["plane_size"]
    all_same = info["all_same"]
    raw = (~all_same) & (size > target)
    codes = torch.where(all_same, 0,
                        torch.where(raw, 1,
                                    torch.where(info["normal_rle"], 3, 2)))
    sizes = torch.where(all_same, 1, torch.where(raw, 256, size))
    return codes.to(torch.int32), sizes
