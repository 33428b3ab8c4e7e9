"""Vectorized 16-value bit packing/unpacking (write_16/read_16_bits layout).

Layout (block_compress.h:562-601): 16 values at b bits are stored as two
groups of 8 values, each group LE-packed into b bytes (value j of a group
occupies bits [j*b, (j+1)*b) of the group's little-endian bit stream).

pack16/pack16_any take the array module as `xp` (numpy on the host
encoder); the *_torch twins are the same math on torch tensors for the plain
versions of the encode and decode kernels.
"""


def _pack_maps(b):
    # For output byte k of 2*b (group g = k // b, byte kk = k % b) and bit m:
    # global bit = kk*8 + m -> value j = g*8 + bit//b, bit position p = bit % b.
    import numpy as np

    ks = np.arange(2 * b)
    ms = np.arange(8)
    g = ks // b
    kk = ks % b
    bit = kk[:, None] * 8 + ms[None, :]
    j = g[:, None] * 8 + bit // b
    p = bit % b
    return j, p


_PACK_CACHE = {}


def pack16(xp, values, b):
    """Pack (..., 16) values at b bits (1..6) -> (..., 2*b) bytes."""
    if b not in _PACK_CACHE:
        _PACK_CACHE[b] = _pack_maps(b)
    j, p = _PACK_CACHE[b]
    j = xp.asarray(j)
    p = xp.asarray(p)
    bits = (values[..., j] >> p) & 1  # (..., 2b, 8)
    weights = 1 << xp.arange(8, dtype=xp.int32)
    return xp.sum(bits * weights, axis=-1).astype(xp.int32)


def pack16_any(xp, values, bits):
    """Pack (..., 16) values at per-row widths `bits` (...,) into (..., 12)
    padded byte buffers (max payload = 2*6). Rows with bits==0 or 8 produce
    zeros (callers handle 0/raw separately). numpy only."""
    out = xp.zeros(values.shape[:-1] + (12,), dtype=xp.int32)
    for b in xp.unique(bits):
        b = int(b)
        if not 1 <= b <= 6:
            continue
        sel = bits == b
        out[sel, : 2 * b] = pack16(xp, values[sel], b)
    return out


def _unpack_maps(b):
    """(src_byte, src_bit) (16, b): bit q of value j sits at bit src_bit of
    packed byte src_byte (the inverse of _pack_maps)."""
    import numpy as np

    if b not in _PACK_CACHE:
        _PACK_CACHE[b] = _pack_maps(b)
    jj, pp = _PACK_CACHE[b]
    src_byte = np.zeros((16, b), dtype=np.int64)
    src_bit = np.zeros((16, b), dtype=np.int64)
    for k in range(2 * b):
        for m in range(8):
            src_byte[jj[k, m], pp[k, m]] = k
            src_bit[jj[k, m], pp[k, m]] = m
    return src_byte, src_bit


def pack16_torch(values, b):
    """torch twin of pack16: (..., 16) int32 values at b bits -> (..., 2*b)."""
    import torch

    if b not in _PACK_CACHE:
        _PACK_CACHE[b] = _pack_maps(b)
    j, p = _PACK_CACHE[b]
    dev = values.device
    j = torch.as_tensor(j, device=dev)
    p = torch.as_tensor(p, dtype=torch.int32, device=dev)
    bits = (values[..., j] >> p) & 1  # (..., 2b, 8)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=dev)
    return (bits * weights).sum(-1, dtype=torch.int32)


def pack16_any_torch(values, bits):
    """torch twin of pack16_any: (..., 16) values at per-row widths `bits`
    -> (..., 12) int32, zero rows where bits is not in 1..6."""
    import torch

    out = torch.zeros(values.shape[:-1] + (12,), dtype=torch.int32,
                      device=values.device)
    for b in range(1, 7):
        sel = bits == b
        out[..., : 2 * b] = torch.where(sel[..., None],
                                        pack16_torch(values, b),
                                        out[..., : 2 * b])
    return out


def unpack16_torch(data, b):
    """torch twin of unpack16: (..., >= 2*b) bytes at width b -> (..., 16)."""
    import torch

    src_byte, src_bit = _unpack_maps(b)
    dev = data.device
    src_byte = torch.as_tensor(src_byte, device=dev)
    src_bit = torch.as_tensor(src_bit, dtype=torch.int32, device=dev)
    bits = (data[..., src_byte] >> src_bit) & 1  # (..., 16, b)
    weights = 1 << torch.arange(b, dtype=torch.int32, device=dev)
    return (bits * weights).sum(-1, dtype=torch.int32)
