"""Anchored Huffman decode: the CUDA kernel and its plain torch version.

decode_streams(stream_bytes, anchors, tables) decodes 32 KiB Huffman
streams (huff_kernel.encode_streams' bitstreams) in 256 independent
segments of 128 symbols each: segment g starts reading backward at bit
anchors[g] and yields natural symbols g*128 .. g*128 + 127. A CUDA tensor
goes through csrc/huff_decode.cu (it replaces the TPU kernel
stenos_tpu/entropy/huff_decode_pallas.py::make_decode_kernel_v6), a CPU
tensor through decode_streams_plain, which follows v6's arithmetic: one
22-bit lookahead serves two symbols; a code's length comes from comparing
the left-aligned 11-bit window with E_l = (base_l + n_l) << (11 - l), its
rank from the window and the per-length offsets (classify); the rank
indexes the (length descending, symbol ascending) symbol list. Bits below
bit 0 and bytes past the row read as zeros. The kernel decodes by table:
decode_lut_plain gives the 2^11-entry lookup it builds for each stream, the
(symbol, length) of every 11-bit window.

  stream_bytes (ns, nbytes) uint8, nbytes % 4 == 0: the bitstreams
  anchors      (ns, 256) int32
  tables       (ns, 304) int32 from decode_tables
  -> (ns, 32768) uint8 symbols, on the input's device
"""

import ctypes

import numpy as np
import torch

from ..ops import _cuda
from .huff_kernel import SEG, SEGS, STREAM, WOUT_WORDS
from .huffman import MAX_BITS, canonical_bases

TABLE = 304  # [base(12) | n(12) | offset(12) | pad(4) | symbols(256) | pad(8)]

# kernel launches (chip_smoke.py reads this)
launches = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {"stenos_huff_decode": [_P, _LL, _P, _P, _LL, _P, _P]}


def decode_tables(lengths):
    """lengths (n, 256) -> (n, 304) int32 decode tables: per length l the
    first canonical code base_l (0 where none), the count n_l and offset_l,
    the rank of the first length-l symbol in the list of used symbols
    sorted by length descending, then symbol ascending; the list follows
    from column 40, zero-filled."""
    lengths = np.asarray(lengths, np.int32)
    base, nl = canonical_bases(lengths)
    out = np.zeros((lengths.shape[0], TABLE), np.int64)
    out[:, 1:12] = base[:, 1:]
    out[:, 13:24] = nl[:, 1:]
    # symbols of the longer lengths come first
    out[:, 25:36] = np.cumsum(nl[:, :0:-1], axis=1)[:, ::-1] - nl[:, 1:]
    used = nl[:, 1:].sum(axis=1)
    # stable sort on (MAX_BITS - length), unused symbols last
    key = np.where(lengths > 0, MAX_BITS - lengths, MAX_BITS + 1)
    order = np.argsort(key, axis=1, kind="stable")
    out[:, 40:296] = np.where(np.arange(256) < used[:, None], order, 0)
    return out.astype(np.int32)


def _window22(buf, r):
    """Bits [r - 22, r) of each row of buf (LE bytes, 4 zero bytes
    appended), zeros below bit 0: v6's W22."""
    lob = (r - 22).clamp(min=0)
    b = (lob >> 3)[..., None] + torch.arange(4, device=buf.device)
    b = b.clamp(max=buf.shape[1] - 1).flatten(1)
    v = torch.gather(buf, 1, b).reshape(*r.shape, 4)
    word = v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16) | (v[..., 3] << 24)
    wn = (word >> (lob & 7)) & 0x3FFFFF
    rc = r.clamp(0, 22)
    w0 = (buf[:, 0] | (buf[:, 1] << 8) | (buf[:, 2] << 16)
          | (buf[:, 3] << 24))[:, None]
    wb = (w0 & ((1 << rc) - 1)) << (22 - rc)
    return torch.where(r >= 22, wn, wb)


def _bounds(tab):
    """E_l and D_l = offset_l - base_l, each (ns, 11) int64 (column i is
    length i + 1), of (ns, 304) int64 tables."""
    lv = torch.arange(1, MAX_BITS + 1, device=tab.device)
    return ((tab[:, 1:12] + tab[:, 13:24]) << (11 - lv),
            tab[:, 25:36] - tab[:, 1:12])


def _classify(tab, W, W8):
    """classify, with W8 in W's place in the compares with the bounds of
    lengths 1-8."""
    E, D = _bounds(tab)
    cnt = torch.zeros_like(W)
    dd = D[:, 10:11].expand_as(W).clone()
    for i in range(11):
        m = ((W8 if i < 8 else W) >= E[:, i:i + 1]).long()
        cnt += m
        if i >= 1:
            dd -= m * (D[:, i:i + 1] - D[:, i - 1:i])
    ln = 11 - cnt
    return ln, (W >> (11 - ln)) + dd


def classify(tab, W):
    """v6's (length, rank) of left-aligned 11-bit windows W (ns, k) int64
    under (ns, 304) int64 tables: the length is 11 minus the number of
    bounds E_l that W reaches, the rank W's top bits plus a telescoped
    per-length offset."""
    return _classify(tab, W, W)


def symbols(tab, ranks):
    """The symbols of ranks (ns, k) under (ns, 304) int64 tables: 0 for a
    rank outside [0, 256)."""
    ok = (ranks >= 0) & (ranks < 256)
    out = torch.gather(tab[:, 40:296], 1, torch.where(ok, ranks, 0))
    return torch.where(ok, out, 0)


def decode_lut_plain(tables):
    """(ns, 304) int32 tables -> (ns, 2048) int32: the lookup the kernel
    builds, entry W = symbol | length << 8 of the left-aligned 11-bit window
    W. Built as the kernel builds it, 8 entries a thread: the bounds of
    lengths 1-8 are multiples of 8, so they are compared with W & ~7, those
    of lengths 9-11 with W; it equals classify for every table."""
    tab = tables.long()
    W = torch.arange(2048, device=tab.device).expand(tab.shape[0], -1)
    ln, rank = _classify(tab, W, W & ~7)
    return (symbols(tab, rank) | ln << 8).to(torch.int32)


def decode_streams_plain(stream_bytes, anchors, tables):
    """Plain torch version, vectorised over streams and segments: 64 steps
    of two symbols (see the module docstring)."""
    ns = stream_bytes.shape[0]
    dev = stream_bytes.device
    buf = torch.cat([stream_bytes, torch.zeros((ns, 4), dtype=torch.uint8,
                                               device=dev)], 1).long()
    tab = tables.long()
    r = anchors.long()
    ranks = torch.empty((ns, SEGS, SEG), dtype=torch.int64, device=dev)
    for k in range(SEG // 2):
        W22 = _window22(buf, r)
        ln0, ranks[:, :, 2 * k] = classify(tab, W22 >> 11)
        ln1, ranks[:, :, 2 * k + 1] = classify(tab,
                                               (W22 >> (11 - ln0)) & 0x7FF)
        r = r - ln0 - ln1
    return symbols(tab, ranks.reshape(ns, STREAM)).to(torch.uint8)


def decode_streams(stream_bytes, anchors, tables):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring)."""
    global launches
    if stream_bytes.device.type == "cpu":
        return decode_streams_plain(stream_bytes, anchors, tables)
    ns, nbytes = stream_bytes.shape
    dev = stream_bytes.device
    for name, t, dtype, width in (("stream_bytes", stream_bytes, torch.uint8,
                                   nbytes),
                                  ("anchors", anchors, torch.int32, SEGS),
                                  ("tables", tables, torch.int32, TABLE)):
        if (t.device != dev or t.dtype != dtype or t.dim() != 2
                or t.shape != (ns, width) or not t.is_contiguous()):
            raise ValueError(f"decode_streams: {name} must be a contiguous "
                             f"({ns}, {width}) {dtype} tensor on {dev}")
    if (dev.type != "cuda" or nbytes % 4 or nbytes > 4 * WOUT_WORDS
            or stream_bytes.data_ptr() % 4):
        raise ValueError(f"decode_streams: unsupported device {dev} or row "
                         f"width {nbytes} (4-byte aligned rows of a multiple "
                         f"of 4 bytes, at most {4 * WOUT_WORDS})")
    lib = _cuda.load("huff_decode", _SIGNATURES)
    out = torch.empty((ns, STREAM), dtype=torch.uint8, device=dev)
    if ns:
        _cuda.check(lib.stenos_huff_decode(
            stream_bytes.data_ptr(), nbytes, anchors.data_ptr(),
            tables.data_ptr(), ns, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "huff_decode")
        launches += 1
    return out
