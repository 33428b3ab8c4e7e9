"""Loader for the native host runtime (stenos_native.cpp, ctypes-bound).

The library is built with g++ on first use through the hash-keyed build
cache in stenos_tpu_torch/build/ (see _build.py). A failed build raises:
the frame layer, the row parser feeding the decode kernel and the LZ
estimators all need it, and there is no slower tier to hide behind.

Only the entry points the port's paths call are bound: lz4_guess_size,
parse_rows, parse_rows_batch and block_decode (the block codec), and
huff_lengths (the device container's entropy stage).
"""

import ctypes
import os

import numpy as np

from .._build import cached_lib

_SRC = os.path.join(os.path.dirname(__file__), "src", "stenos_native.cpp")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-DNDEBUG", "-shared",
          "-fPIC", "-fvisibility=hidden"]

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t


def _ptr(a):
    return a.ctypes.data_as(_P)


class _Native:
    def __init__(self, cdll):
        self._lib = cdll
        cdll.stn_lz4_guess_size.restype = _SZ
        cdll.stn_lz4_guess_size.argtypes = [ctypes.c_char_p, _SZ, ctypes.c_int]
        cdll.stn_block_decode.restype = ctypes.c_ssize_t
        cdll.stn_block_decode.argtypes = [_P, _SZ, _SZ, _SZ, _P, _P]
        cdll.stn_parse_rows.restype = ctypes.c_ssize_t
        cdll.stn_parse_rows.argtypes = [
            _P, _SZ, _SZ, _SZ, _P, _P, _P, _P, _P, _SZ, _P, _P, _P, _P, _P]
        cdll.stn_parse_rows_batch.restype = ctypes.c_ssize_t
        cdll.stn_parse_rows_batch.argtypes = [
            _P, _SZ, _SZ, _SZ, _SZ, _P, _P, _SZ, _P, _P, _P, _P, _P]
        cdll.stn_huff_lengths.restype = None
        cdll.stn_huff_lengths.argtypes = [_P, _SZ, ctypes.c_int32, _P]

    def lz4_guess_size(self, data, accel: int) -> int:
        data = bytes(data)
        return self._lib.stn_lz4_guess_size(data, len(data), accel)

    def parse_rows(self, src, bpp: int, nbytes: int):
        """Row-level decode index for the decode kernel.

        Returns (vbuf, plane_off i32[P], row_rel i32[P,16], row_hdr u8[P,16],
        row_min u8[P,16], tail_bytes, consumed) or a negative error. vbuf is
        the VIRTUAL stream: the payload with LZ/COPY blocks replaced inline
        by decoded shuffled planes; plane_off indexes vbuf, row_rel is
        relative to each plane's offset. tail_bytes = decoded partial tail.
        """
        src = bytes(src)
        block_size = 256 * bpp
        nb = 1 if nbytes == block_size else nbytes // block_size
        P = max(nb * bpp, 1)
        row_hdr = np.zeros(P * 16, dtype=np.uint8)
        row_min = np.zeros(P * 16, dtype=np.uint8)
        row_rel = np.zeros(P * 16, dtype=np.int32)
        plane_off = np.zeros(P, dtype=np.int32)
        patch_cap = nbytes + 2 * block_size
        patch = np.empty(patch_cap, dtype=np.uint8)
        patch_len = np.zeros(1, dtype=np.int64)
        tail_info = np.zeros(2, dtype=np.int64)
        splices = np.zeros((max(nb, 1), 3), dtype=np.int64)
        n_splices = np.zeros(1, dtype=np.int64)
        scratch = np.empty(512 * bpp + 16, dtype=np.uint8)
        r = self._lib.stn_parse_rows(
            src, len(src), bpp, nbytes, _ptr(row_hdr), _ptr(row_min),
            _ptr(row_rel), _ptr(plane_off), _ptr(patch), patch_cap,
            _ptr(patch_len), _ptr(tail_info), _ptr(splices),
            _ptr(n_splices), _ptr(scratch))
        if r < 0:
            return int(r)
        stream = np.frombuffer(src, np.uint8)
        nspl = int(n_splices[0])
        if nspl:
            pieces = []
            prev = 0
            for k in range(nspl):
                sp, skip, ppos = splices[k]
                pieces.append(stream[prev:sp])
                pieces.append(patch[ppos : ppos + block_size])
                prev = sp + skip
            pieces.append(stream[prev:])
            vbuf = np.concatenate(pieces)
        else:
            vbuf = stream
        tail = patch[int(tail_info[0]) : int(tail_info[0]) + int(tail_info[1])] \
            if tail_info[1] else np.zeros(0, np.uint8)
        return (vbuf, plane_off, row_rel.reshape(P, 16),
                row_hdr.reshape(P, 16), row_min.reshape(P, 16), tail, int(r))

    def parse_rows_batch(self, frame, bpp: int, sb: int, offs, csizes,
                         row_bytes: int):
        """Batched decode index for full method-BLOCK superblocks.

        frame: whole frame bytes; offs/csizes: per-superblock payload spans.
        Returns (vbufs (n,row_bytes) u8, plane_off (n,P) i32,
        rowtab (n,16,P) i32 packed rel|hdr<<10|min<<14,
        vlens (n,) i64 per-superblock VIRTUAL lengths) or a negative error.
        vlens can exceed csize: LZ/COPY blocks are inlined expanded — always
        bound the virtual stream by vlens, never by csize.
        If row_bytes is too small for the expanded stream, retries once at
        the worst-case bound (csize + sb per record).
        """
        frame = bytes(frame)
        n_sb = len(offs)
        P = sb // 256
        vbufs = np.empty((n_sb, row_bytes), np.uint8)
        plane_off = np.empty((n_sb, P), np.int32)
        rowtab = np.empty((n_sb, 16, P), np.int32)
        offs = np.ascontiguousarray(offs, np.int64)
        csizes = np.ascontiguousarray(csizes, np.int64)
        vlens = np.zeros(n_sb, np.int64)
        scratch = np.empty(512 * bpp + 16, np.uint8)
        r = self._lib.stn_parse_rows_batch(
            frame, len(frame), bpp, sb, n_sb, _ptr(offs), _ptr(csizes),
            row_bytes, _ptr(vbufs), _ptr(plane_off), _ptr(rowtab),
            _ptr(vlens), _ptr(scratch))
        if r == -4 and row_bytes < int(csizes.max()) + sb:  # ERR_INPUT
            # LZ inlining expanded past row_bytes: retry at the hard bound
            # (each block inflates by at most 256*bpp over its stream bytes)
            wide = int(csizes.max()) + sb + 16
            return self.parse_rows_batch(frame, bpp, sb, list(offs),
                                         list(csizes), wide)
        if r < 0:
            return int(r)
        return vbufs, plane_off, rowtab, vlens

    def block_decode(self, src, bpp: int, nbytes: int):
        """Decode a block stream -> numpy uint8 array or negative error."""
        src = bytes(src)
        dst = np.empty(nbytes, dtype=np.uint8)
        scratch = np.empty(256 * bpp, dtype=np.uint8)
        r = self._lib.stn_block_decode(src, len(src), bpp, nbytes, _ptr(dst),
                                       _ptr(scratch))
        if r < 0:
            return int(r)
        return dst


    def huff_lengths(self, counts, max_bits: int = 11):
        """counts (n, 256) int64 -> length-limited Huffman lengths (n, 256)
        int32 (0 = unused symbol)."""
        counts = np.ascontiguousarray(counts, np.int64)
        out = np.zeros((counts.shape[0], 256), np.uint8)
        self._lib.stn_huff_lengths(_ptr(counts), counts.shape[0], max_bits,
                                   _ptr(out))
        return out.astype(np.int32)


_cached = None


def load() -> _Native:
    """The native runtime, built on first use; raises when it cannot be."""
    global _cached
    if _cached is None:
        path = cached_lib(["g++", *_FLAGS], _SRC, "stenos_native")
        _cached = _Native(ctypes.CDLL(path))
    return _cached
