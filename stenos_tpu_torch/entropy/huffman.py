"""Huffman table construction for zstd literals (RFC 8878 §4.2.1), on the
host: the counterpart of the parts of stenos_tpu/entropy/huffman.py that the
device container's entropy stage calls.

Lengths are capped at MAX_BITS = 11 and complete (sum of 2^-len is 1 for two
or more used symbols). Canonical codes are dealt from value 0 upward,
starting at the LONGEST length, symbols ascending within a length, as the
zstd decoder rebuilds them from weights.
"""

import numpy as np

from .. import native

MAX_BITS = 11


def code_lengths_batch(counts, max_bits: int = MAX_BITS):
    """counts (n, 256) -> length-limited code lengths (n, 256) int32 (0 =
    unused), computed natively (stn_huff_lengths)."""
    return native.load().huff_lengths(counts, max_bits)


def canonical_bases(lengths):
    """(base, count) per length, each (n, MAX_BITS + 1) int64, of (n, 256)
    lengths: count_l symbols have length l, and their canonical codes start
    at base_l, with base_MAX = 0 and base_l = (base_l' + count_l') >> (l' - l)
    for the next longer length l'."""
    lengths = np.asarray(lengths, np.int32)
    nl = np.stack([(lengths == ln).sum(axis=1)
                   for ln in range(MAX_BITS + 1)], axis=1).astype(np.int64)
    base = np.zeros_like(nl)
    code = np.zeros(lengths.shape[0], np.int64)
    prev = MAX_BITS
    for ln in range(MAX_BITS, 0, -1):
        code >>= (prev - ln)
        prev = ln
        base[:, ln] = code
        code = code + nl[:, ln]
    return base, nl


def build_ctables_batch(lengths):
    """Canonical code assignment for (n, 256) lengths -> (n, 256) uint32
    codes: for length l the codes are base_l + rank among the length-l
    symbols (canonical_bases)."""
    lengths = np.asarray(lengths, np.int32)
    base, _ = canonical_bases(lengths)
    codes = np.zeros(lengths.shape, np.int64)
    for ln in range(1, MAX_BITS + 1):
        m = lengths == ln
        rank = np.cumsum(m, axis=1) - m
        codes = np.where(m, base[:, ln:ln + 1] + rank, codes)
    return codes.astype(np.uint32)


def luts_batch(counts):
    """counts (n, 256) -> (lengths, LUTs): the code lengths and the stream
    encode's tables, code | length << 11, both (n, 256) int32."""
    lens = code_lengths_batch(counts)
    return lens, build_ctables_batch(lens).astype(np.int32) | (lens << 11)
