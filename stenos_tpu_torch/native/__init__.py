"""Loader for the native host runtime (stenos_native.cpp, ctypes-bound).

The library is built with g++ on first use through the hash-keyed build
cache in stenos_tpu_torch/build/ (see _build.py). A failed build raises:
the frame layer, the row parser feeding the decode kernel and the LZ
estimators all need it, and there is no slower tier to hide behind.

Only the entry points the port's paths call are bound: lz4_guess_size,
parse_rows_batch, parse_rows_ptrs, zstd_unpack (libzstd through the
caller's function pointers) and block_decode (the block codec),
huff_lengths (the device container's entropy stage), and for the zstd
entropy stage: huff_tree_descs, matchiness, match_parse, encode_block and
recode_reps_enc (encode); zstd_ctx, zstd_dtables, resolve_reps,
huf_anchors, seq_ops and zstd_prep_batch (decode).
"""

import ctypes
import os

import numpy as np

from .._build import cached_lib

_SRC = os.path.join(os.path.dirname(__file__), "src", "stenos_native.cpp")
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-DNDEBUG", "-shared",
          "-fPIC", "-fvisibility=hidden", "-pthread"]

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_SSZ = ctypes.c_ssize_t
_I = ctypes.c_int
_I64 = ctypes.c_int64


def _ptr(a):
    return a.ctypes.data_as(_P)


def _fn(f):
    """The address of a ctypes foreign function."""
    return ctypes.cast(f, _P).value


class _Native:
    def __init__(self, cdll):
        self._lib = cdll
        cdll.stn_lz4_guess_size.restype = _SZ
        cdll.stn_lz4_guess_size.argtypes = [ctypes.c_char_p, _SZ, ctypes.c_int]
        cdll.stn_block_decode.restype = ctypes.c_ssize_t
        cdll.stn_block_decode.argtypes = [_P, _SZ, _SZ, _SZ, _P, _P]
        cdll.stn_parse_rows_ptrs.restype = ctypes.c_ssize_t
        cdll.stn_parse_rows_ptrs.argtypes = [
            _P, _P, _SZ, _SZ, _SZ, _SZ, _P, _P, _P, _P, _I]
        cdll.stn_parse_rows.restype = ctypes.c_ssize_t
        cdll.stn_parse_rows.argtypes = [_P, _SZ, _SZ, _SZ, _SZ, _P, _P, _P,
                                        _P, _P]
        cdll.stn_zstd_sizes.restype = None
        cdll.stn_zstd_sizes.argtypes = [_P, _P, _P, _SZ, _P]
        cdll.stn_zstd_unpack.restype = None
        cdll.stn_zstd_unpack.argtypes = [_P, _P, _P, _P, _P, _P, _SZ, _I, _P]
        cdll.stn_huff_lengths.restype = None
        cdll.stn_huff_lengths.argtypes = [_P, _SZ, ctypes.c_int32, _P]
        cdll.stn_huff_tree_descs.restype = None
        cdll.stn_huff_tree_descs.argtypes = [_P, _SZ, _P, _P]
        cdll.stn_zstd_ctx_size.restype = _SZ
        cdll.stn_zstd_ctx_size.argtypes = []
        for name, args in (
                ("stn_zstd_dtables", [_P, _SZ, _P, _P, _P]),
                ("stn_resolve_reps", [_SZ, _P, _P, _P, _P]),
                ("stn_recode_reps_enc", [_SZ, _P, _P, _P, _P]),
                ("stn_huf_anchors", [_P, _SZ, _SZ, _P, _P, _P]),
                ("stn_seq_ops", [_SZ, _P, _P, _P, _I64, _I64, _I64, _I64,
                                 ctypes.c_int32, _P, _SZ]),
                ("stn_match_parse", [_P, _SZ, _P, _I, _P, _SZ, _P, _P, _P]),
                ("stn_encode_block", [_P, _SZ, _P, _I, _I, _P, _P, _SZ])):
            fn = getattr(cdll, name)
            fn.restype = _SSZ
            fn.argtypes = args
        cdll.stn_zstd_prep_batch.restype = _P
        cdll.stn_zstd_prep_batch.argtypes = [_P, _P, _P, _P, _SZ, _I, _I64,
                                             _P, _P]
        cdll.stn_zstd_prep_fetch.restype = None
        cdll.stn_zstd_prep_fetch.argtypes = [_P, _P, _P, _P, _P, _I64, _P,
                                             _P, _P, _P, _P, _P]
        cdll.stn_zstd_prep_free.restype = None
        cdll.stn_zstd_prep_free.argtypes = [_P]
        cdll.stn_matchiness.restype = ctypes.c_double
        cdll.stn_matchiness.argtypes = [_P, _SZ, _SZ]

    def lz4_guess_size(self, data, accel: int) -> int:
        data = bytes(data)
        return self._lib.stn_lz4_guess_size(data, len(data), accel)

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
        frame = np.frombuffer(bytes(frame), np.uint8)
        offs = np.ascontiguousarray(offs, np.int64)
        csizes = np.ascontiguousarray(csizes, np.int64)
        n_sb = len(offs)
        P = sb // 256
        vbufs = np.empty((n_sb, row_bytes), np.uint8)
        plane_off = np.empty((n_sb, P), np.int32)
        rowtab = np.empty((n_sb, 16, P), np.int32)
        vlens = np.zeros(n_sb, np.int64)
        past = np.flatnonzero(offs + csizes > len(frame))
        k = int(past[0]) if len(past) else n_sb  # the first past the frame
        _, r = self.parse_rows_ptrs(frame.ctypes.data + offs[:k], csizes[:k],
                                    bpp, sb, row_bytes, vbufs, plane_off,
                                    rowtab, vlens)
        if r == 0 and k < n_sb:
            r = -2  # ERR_SRC
        if r == -4 and row_bytes < int(csizes.max()) + sb:  # ERR_INPUT
            # LZ inlining expanded past row_bytes: retry at the hard bound
            # (each block inflates by at most 256*bpp over its stream bytes)
            wide = int(csizes.max()) + sb + 16
            return self.parse_rows_batch(frame, bpp, sb, offs, csizes, wide)
        if r < 0:
            return int(r)
        return vbufs, plane_off, rowtab, vlens

    def parse_rows_ptrs(self, srcs, csizes, bpp: int, sb: int,
                        row_bytes: int, vbufs, plane_off, rowtab, vlens,
                        threads: int = 1):
        """parse_rows_batch's index of full method-BLOCK superblocks whose
        block streams lie anywhere in host memory, on up to `threads`
        threads: stream i is csizes[i] bytes at address srcs[i] (int64
        arrays). Writes row i of the C-contiguous arrays vbufs (n,
        row_bytes) uint8, plane_off (n, P) and rowtab (n, 16, P) int32 and
        vlens (n,) int64, as parse_rows_batch returns them. Returns (n, 0),
        or (i, error) for the first stream i that does not parse (rows
        before it are written)."""
        srcs = np.ascontiguousarray(srcs, np.int64)
        csizes = np.ascontiguousarray(csizes, np.int64)
        r = self._lib.stn_parse_rows_ptrs(
            _ptr(srcs), _ptr(csizes), len(srcs), bpp, sb, row_bytes,
            _ptr(vbufs), _ptr(plane_off), _ptr(rowtab), _ptr(vlens), threads)
        if r == 0:
            return len(srcs), 0
        return (-r >> 8) - 1, -(-r & 255)

    def parse_rows(self, src, bpp: int, nbytes: int):
        """The row index of one block stream that decodes to nbytes (at
        least one full block of 256 * bpp bytes): (vbufs (1, row_bytes)
        uint8, plane_off (1, P) and rowtab (1, 16, P) int32 over its nb full
        blocks, P = nb * bpp, as parse_rows_ptrs writes them, and its partial
        tail decoded (uint8, nbytes - nb * 256 * bpp bytes)), or a negative
        error. Retries once with rows wide enough for LZ inlining."""
        src = np.frombuffer(bytes(src), np.uint8)
        nb = nbytes // (256 * bpp)
        P = nb * bpp
        tail = np.empty(nbytes - nb * 256 * bpp, np.uint8)
        r = -4
        for rb in (len(src) + 32, len(src) + nb * 256 * bpp + 16):
            rb = (rb + 15) // 16 * 16
            vbufs = np.empty((1, rb), np.uint8)
            plane_off = np.empty((1, P), np.int32)
            rowtab = np.empty((1, 16, P), np.int32)
            r = self._lib.stn_parse_rows(
                _ptr(src), len(src), bpp, nbytes, rb, _ptr(vbufs),
                _ptr(plane_off), _ptr(rowtab), _ptr(np.empty(1, np.int64)),
                _ptr(tail))
            if r != -4:  # ERR_INPUT: LZ inlining grew past the row
                break
        if r < 0:
            return int(r)
        return vbufs, plane_off, rowtab, tail

    def zstd_unpack(self, srcs, lens, cap: int, threads: int):
        """Host libzstd (the binding of host/zstd.py) over n zstd frames in
        memory, frame i lens[i] bytes at address srcs[i] (int64 arrays),
        each into a buffer of its declared content size, on up to `threads`
        threads. Returns (buf, starts, n_ok): frame i's bytes are
        buf[starts[i] : starts[i + 1]] for i < n_ok; frame n_ok, when there
        is one, declares no size or more than cap, or does not decode."""
        from ..host import zstd as zstd_host

        zl = zstd_host._zstd()
        srcs = np.ascontiguousarray(srcs, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        n = len(srcs)
        sizes = np.empty(n, np.uint64)
        self._lib.stn_zstd_sizes(_fn(zl.ZSTD_getFrameContentSize),
                                 _ptr(srcs), _ptr(lens), n, _ptr(sizes))
        bad = np.flatnonzero(sizes > cap)
        n_ok = int(bad[0]) if len(bad) else n
        starts = np.zeros(n_ok + 1, np.int64)
        np.cumsum(sizes[:n_ok].astype(np.int64), out=starts[1:])
        buf = np.empty(max(int(starts[-1]), 1), np.uint8)
        dsts = buf.ctypes.data + starts[:-1]
        caps = np.diff(starts)
        got = np.empty(n_ok, np.int64)
        self._lib.stn_zstd_unpack(
            _fn(zl.ZSTD_decompress), _fn(zl.ZSTD_isError), _ptr(srcs),
            _ptr(lens), _ptr(dsts), _ptr(caps), n_ok, threads, _ptr(got))
        bad = np.flatnonzero(got != caps)
        return buf, starts, int(bad[0]) if len(bad) else n_ok

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

    def huff_tree_descs(self, lengths):
        """lengths (n, 256) -> list of serialized Huffman tree descriptions
        (None where the block must fall back to raw literals)."""
        lengths = np.ascontiguousarray(lengths, np.uint8)
        n = lengths.shape[0]
        out = np.zeros((n, 132), np.uint8)
        sizes = np.zeros(n, np.int32)
        self._lib.stn_huff_tree_descs(_ptr(lengths), n, _ptr(out),
                                      _ptr(sizes))
        return [bytes(out[i][: sizes[i]]) if sizes[i] else None
                for i in range(n)]

    def zstd_ctx(self):
        """Fresh per-frame zstd decode context (the Repeat_Mode FSE tables
        and the Treeless_Literals Huffman table persist across blocks in
        it)."""
        return np.zeros(int(self._lib.stn_zstd_ctx_size()), np.uint8)

    def zstd_dtables(self, sec, ctx):
        """Header and table prep of one sequences section for the sequence
        decode kernel: the nseq header, the modes and the three FSE decode
        tables (Repeat_Mode persists in ctx), without walking the
        bitstream. Returns (nseq, meta (8,) int32, tab (1536,) int32) or a
        negative error. meta = [nseq, bitstream byte offset, initial bit
        cursor, tl_ll, tl_of, tl_ml, 0, 0]; tab row ch*512 + state packs
        sym | nb << 8 | base << 16, channels LL, OF, ML."""
        sec = bytes(sec)
        tab = np.zeros(3 * 512, np.int32)
        meta = np.zeros(8, np.int32)
        r = self._lib.stn_zstd_dtables(sec, len(sec), _ptr(ctx), _ptr(tab),
                                       _ptr(meta))
        if r < 0:
            return int(r)
        return int(r), meta, tab

    def recode_reps_enc(self, ll, ofv, reps):
        """Encode-side repeat-offset recode: raw offset_values (offset + 3)
        become repeat codes 1-3 where the registers match; reps (3,) int64
        updated in place. Returns the recoded offset values or a negative
        error."""
        ll = np.ascontiguousarray(ll, np.int32)
        ofv = np.ascontiguousarray(ofv, np.int32)
        n = len(ll)
        out = np.empty(max(n, 1), np.int32)
        r = self._lib.stn_recode_reps_enc(n, _ptr(ll), _ptr(ofv),
                                          _ptr(reps), _ptr(out))
        if r < 0:
            return int(r)
        return out[:n]

    def resolve_reps(self, ll, ofv, reps):
        """Repcode resolution of RAW (ll, offset_value) pairs; reps (3,)
        int64 updated in place. Returns the offsets (n,) int64 or a
        negative error."""
        ll = np.ascontiguousarray(ll, np.int32)
        ofv = np.ascontiguousarray(ofv, np.int32)
        n = len(ll)
        off = np.empty(max(n, 1), np.int64)
        r = self._lib.stn_resolve_reps(n, _ptr(ll), _ptr(ofv), _ptr(reps),
                                       _ptr(off))
        if r < 0:
            return int(r)
        return off[:n]

    def huf_anchors(self, sec, regenerated: int, ctx):
        """Length-only anchor scan of a 4-stream Huffman literals section
        (the bytes after the literals header): (lens (256,) uint8, anchors
        (4, 256) int32) in the sidecar's contract, or a negative error.
        Updates ctx's table as huf_lits would."""
        sec = bytes(sec)
        lens = np.zeros(256, np.uint8)
        anch = np.zeros((4, 256), np.int32)
        r = self._lib.stn_huf_anchors(sec, len(sec), regenerated, _ptr(ctx),
                                      _ptr(lens), _ptr(anch))
        if r < 0:
            return int(r)
        return lens, anch

    def seq_ops(self, ll, ml, off, dst_base: int, lit_base: int,
                trailing: int, out_limit: int, W: int = 512):
        """W-chunked copy-op program of one block's sequences: (nops, 3)
        int32 ops (dst, src, flag: 1 = literal source), destination-ordered,
        each copying W bytes of which only those before the next op's dst
        count. Returns the ops or a negative error."""
        ll = np.ascontiguousarray(ll, np.int32)
        ml = np.ascontiguousarray(ml, np.int32)
        off = np.ascontiguousarray(off, np.int64)
        n = len(ll)
        total = int(ll.sum() + ml.sum()) + int(trailing)
        # worst case per sequence: one literal op, log2(W) bootstrap ops of
        # an overlapping match, then the W-stride bulk ops
        cap = (W.bit_length() + 3) * max(n, 1) + total // W + 64
        ops = np.empty((cap, 3), np.int32)
        r = self._lib.stn_seq_ops(n, _ptr(ll), _ptr(ml), _ptr(off),
                                  dst_base, lit_base, trailing, out_limit, W,
                                  _ptr(ops), cap)
        if r < 0:
            return int(r)
        return ops[:r]

    def zstd_prep_batch(self, buf, offs, lens, dsizes, threads: int,
                        max_stream: int):
        """Host pass of the batched device zstd decode over the payloads
        buf[offs[i] : offs[i] + lens[i]] (dsizes[i] bytes each), on
        up to `threads` threads (one for each 8 anchor scans of foreign
        literals). Returns (status (n,) int32: 0 ok, 1 the host
        ladder, 2 corrupt; then, over the ok payloads in order: blocks
        (nblk, 5) int64 [payload, regenerated, host literal offset, job or
        -1, section or -1], rows (4 njobs, width) uint8 (each K5 job's 4
        streams, zero-padded to the longest, a multiple of 4), anchors
        (4 njobs, 256) int32, lens (njobs, 256) uint8, K5's tables (4 njobs,
        304) int32 (decode_tables of each job's lens, a row a stream), meta
        (nsec, 8) int64 (K7's, stream offsets into buf), tabs (nsec, 1536)
        int32, the host literals (nlits,) uint8, and the number of anchor
        scans it ran). buf: a uint8 array."""
        offs = np.ascontiguousarray(offs, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        dsizes = np.ascontiguousarray(dsizes, np.int64)
        n = len(offs)
        status = np.zeros(n, np.int32)
        counts = np.zeros(6, np.int64)
        h = self._lib.stn_zstd_prep_batch(_ptr(buf), _ptr(offs), _ptr(lens),
                                          _ptr(dsizes), n, threads,
                                          max_stream, _ptr(status),
                                          _ptr(counts))
        try:
            nb, nj, ns, nl, longest, scans = (int(c) for c in counts)
            width = max(4, -(-longest // 4) * 4)
            out = (np.empty((nb, 5), np.int64),
                   np.empty((4 * nj, width), np.uint8),
                   np.empty((4 * nj, 256), np.int32),
                   np.empty((nj, 256), np.uint8),
                   np.empty((4 * nj, 304), np.int32),
                   np.empty((ns, 8), np.int64),
                   np.empty((ns, 3 * 512), np.int32),
                   np.empty(nl, np.uint8))
            self._lib.stn_zstd_prep_fetch(h, _ptr(buf), _ptr(offs),
                                          _ptr(out[0]), _ptr(out[1]), width,
                                          *(_ptr(a) for a in out[2:]))
        finally:
            self._lib.stn_zstd_prep_free(h)
        return (status, *out, scans)

    def matchiness(self, data, sample_n: int = 16384) -> float:
        """Duplicate-4-gram fraction of the block's first sample_n
        positions (the host routing probe)."""
        data = np.ascontiguousarray(data, np.uint8)
        return float(self._lib.stn_matchiness(_ptr(data), len(data),
                                              sample_n))

    def match_parse(self, data, cand=None, reps=(1, 4, 8)):
        """Greedy LZ77 parse of one block (<= 128 KiB): the fp4-map walk
        (cand None) or the walk over device match candidates. reps: the
        running repeat-offset registers. Returns (seqs, lits) or None."""
        data = np.ascontiguousarray(data, np.uint8)
        n = len(data)
        carr = np.zeros(1, np.int32) if cand is None else \
            np.ascontiguousarray(cand, np.int32)
        cap = n // 3 + 16
        seqs = np.empty((cap, 3), np.int32)
        lits = np.empty(n + 16, np.uint8)
        nlits = np.zeros(1, np.int64)
        rarr = np.asarray(reps, np.int64)
        r = self._lib.stn_match_parse(_ptr(data), n, _ptr(carr),
                                      int(cand is not None), _ptr(seqs), cap,
                                      _ptr(lits), _ptr(nlits), _ptr(rarr))
        if r <= 0:
            return None
        return ([tuple(int(v) for v in t) for t in seqs[:r]],
                lits[: int(nlits[0])].copy())

    def encode_block(self, data, last: bool, reps, cand=None):
        """One whole zstd block. reps: (3,) int64 running repeat-offset
        registers, updated in place. Raises on failure."""
        data = np.ascontiguousarray(data, np.uint8)
        n = len(data)
        carr = np.zeros(1, np.int32) if cand is None else \
            np.ascontiguousarray(cand, np.int32)
        out = np.empty(n + 32, np.uint8)
        r = self._lib.stn_encode_block(_ptr(data), n, _ptr(carr),
                                       int(cand is not None), int(last),
                                       _ptr(reps), _ptr(out), out.size)
        if r < 0:
            raise RuntimeError(f"stn_encode_block: {r}")
        return bytes(out[:r])


_cached = None


def load() -> _Native:
    """The native runtime, built on first use; raises when it cannot be."""
    global _cached
    if _cached is None:
        path = cached_lib(["g++", *_FLAGS], _SRC, "stenos_native")
        _cached = _Native(ctypes.CDLL(path))
    return _cached
