"""Decode of zstd entropy payloads on the card: the port of
stenos_tpu/entropy/device_decode.py (decode_payload_device and its two
tiers).

Covers the payloads of methods ZSTD, TRANSPOSED_ZSTD and
TRANSPOSED_DELTA_ZSTD, this package's frames and libzstd's alike.

1. Literals-only frames with a decode-anchor sidecar (sidecar.py), every
   block a full 128 KiB: the host walks the headers only, and every
   Huffman stream decodes through the anchored decode kernel (K5,
   huff_decode_kernel.py).
2. Everything else. Per block, the literals decode through K5 when the
   sidecar has the block's anchors or a length-only native scan finds them
   (stn_huf_anchors, the route of libzstd's frames), and through the
   native huf_lits otherwise; K5's rows are patched into the literal and
   output buffers on the card by torch slicing. Every sequences section
   decodes through K7 (seqdec_kernel.py) after a host O(table) prep that
   chains the FSE Repeat_Mode tables through the blocks in order; its raw
   triples come back for the repeat-offset resolution (native
   resolve_reps), chained across blocks from the registers [1, 4, 8]. The
   sequences then execute through X1 (seq_exec.py): one lane per block
   when no match reaches before its block, else one lane over the whole
   frame in order.

A payload whose frame, block or section headers the parsers here reject
returns None, and the frame layer asks host libzstd: the ladder of
stenos.cpp:681-753. host_ladder counts those payloads, and the first of
them warns. Once the headers parse, a K7 error flag and any other
inconsistency (literals, repeat offsets, sizes, a match before the frame)
raise StenosError(ERROR_INVALID_INPUT), as host libzstd's failure does: a
kernel fault never turns into host work.
"""

import warnings

import numpy as np
import torch

from .. import native
from ..constants import ERROR_INVALID_INPUT
from ..frame import StenosError
from .huff_decode_kernel import decode_streams, decode_tables
from .huff_kernel import WOUT_WORDS
from .seq_exec import execute
from .seqdec_kernel import decode_sections, pack_sections, prep_section
from .sidecar import split_sidecar
from .zstd_parse import parse_frame

BLOCK_MAX = 131072

# payloads handed back to host libzstd (chip_smoke.py reads this)
host_ladder = 0


def _corrupt():
    raise StenosError(ERROR_INVALID_INPUT)


def _spans(payload, p: int, lit_end: int):
    """The 4 stream byte spans of a Huffman literals section whose tree
    description starts at p, or None."""
    tb = payload[p]
    p += 1 + (tb if tb < 128 else ((tb - 127) + 1) // 2)
    if p + 6 > lit_end:
        return None
    j1, j2, j3 = (int.from_bytes(payload[p + 2 * i : p + 2 * i + 2],
                                 "little") for i in range(3))
    p += 6
    s4 = lit_end - (p + j1 + j2 + j3)
    if s4 <= 0:
        return None
    return [(p, j1), (p + j1, j2), (p + j1 + j2, j3), (p + j1 + j2 + j3, s4)]


def _parse_device_block(payload: bytes, start: int, bsize: int):
    """This package's literals-only block: 5-byte literals header (type 2,
    size format 3), tree description, jump table, 4 streams, one zero
    sequences byte. Returns (regenerated, [4 stream spans]) or None."""
    end = start + bsize
    h = int.from_bytes(payload[start : start + 5], "little")
    if (h & 3) != 2 or ((h >> 2) & 3) != 3:
        return None
    lit_end = start + 5 + ((h >> 22) & 0x3FFFF)
    if lit_end > end:
        return None
    spans = _spans(payload, start + 5, lit_end)
    if spans is None or payload[lit_end:end] != b"\x00":
        return None
    return (h >> 4) & 0x3FFFF, spans


def _stream_rows(payload, jobs, device):
    """K5 over every job's 4 streams: jobs are (spans, (lens, anchors)).
    Returns (4 * len(jobs), 32768) uint8 on device; each stream's valid
    prefix is its own symbol count. The callers keep every stream within
    K5's width (_fits)."""
    ns = 4 * len(jobs)
    eb = -(-max(max(ln for spans, _ in jobs for _, ln in spans), 1) // 4) * 4
    sb = np.zeros((ns, eb), np.uint8)
    anch = np.zeros((ns, 256), np.int32)
    tabs = np.zeros((ns, 304), np.int32)
    pv = np.frombuffer(payload, np.uint8)
    for b, (spans, (lens, anchors)) in enumerate(jobs):
        tab = decode_tables(np.asarray(lens)[None])
        for s, (off, ln) in enumerate(spans):
            sb[4 * b + s, :ln] = pv[off : off + ln]
            anch[4 * b + s] = anchors[s]
            tabs[4 * b + s] = tab[0]
    return decode_streams(*(torch.from_numpy(a).to(device)
                            for a in (sb, anch, tabs)))


def _fits(spans):
    """Whether every stream fits K5's input width (a valid stream of at
    most 32 KiB symbols always does)."""
    return all(ln <= 4 * WOUT_WORDS for _, ln in spans)


def _patch(buf, rows, patches):
    """Write each patch's literals, streams rows[rb : rb + 4] holding
    ceil(n/4), ceil(n/4), ceil(n/4) and the rest of its n symbols, into
    buf[off : off + n]."""
    for rb, n, off in patches:
        s1 = (n + 3) // 4
        buf[off : off + n] = torch.cat([rows[rb, :s1], rows[rb + 1, :s1],
                                        rows[rb + 2, :s1],
                                        rows[rb + 3, : n - 3 * s1]])


def _decode_literals_only(payload, dsize, blocks, entries, device):
    """Tier 1: every block a full-size literals-only block with anchors."""
    jobs = []
    for spec, ent in zip(blocks, entries):
        if ent is None or spec.btype != 2:
            return None
        pb = _parse_device_block(payload, spec.start, spec.size)
        if pb is None or pb[0] != BLOCK_MAX or not _fits(pb[1]):
            return None
        jobs.append((pb[1], ent))
    if len(jobs) * BLOCK_MAX != dsize:
        return None
    return _stream_rows(payload, jobs, device).reshape(dsize)


def _decode_blocks(payload, dsize, blocks, entries, device):
    """Tier 2 (see the module docstring). Returns (dsize,) uint8 on device
    or None."""
    lib = native.load()
    pv = np.frombuffer(payload, np.uint8)
    ctx = lib.zstd_ctx()
    if entries is not None and len(entries) != len(blocks):
        entries = None
    # pass 1, headers: per block ("direct", size, host bytes or None, job)
    # or ("seq", regenerated, host literals or None, job, prep)
    recs, jobs = [], []
    for bi, spec in enumerate(blocks):
        if spec.btype in (0, 1):
            piece = (pv[spec.start : spec.start + spec.size]
                     if spec.btype == 0
                     else np.full(spec.rsize, pv[spec.start], np.uint8))
            if len(piece) > BLOCK_MAX:
                return None
            recs.append(("direct", len(piece), piece, None))
            continue
        lit = spec.lit
        if lit.regenerated > BLOCK_MAX:
            return None
        ent = entries[bi] if entries is not None else None
        huf4 = (lit.kind == "huf" and lit.four and not lit.treeless
                and lit.regenerated >= 64)
        if ent is None and huf4:
            r = lib.huf_anchors(payload[lit.off : lit.off + lit.length],
                                lit.regenerated, ctx)
            if not isinstance(r, int):
                ent = r
        job = None
        if ent is not None and huf4:
            spans = _spans(payload, lit.off, lit.off + lit.length)
            if spans is not None and _fits(spans):
                jobs.append((spans, ent))
                job = len(jobs) - 1
        lits = None
        if job is None:
            if lit.kind == "raw":
                lits = pv[lit.off : lit.off + lit.length]
            elif lit.kind == "rle":
                lits = np.full(lit.regenerated, lit.byte, np.uint8)
            else:
                lits = lib.huf_lits(payload[lit.off : lit.off + lit.length],
                                    lit.four, lit.treeless, lit.regenerated,
                                    ctx)
                if isinstance(lits, int):
                    if lit.treeless:
                        return None  # its table came in a sidecar entry
                    _corrupt()
        prep = None
        if not (spec.seq_len == 1 and payload[spec.seq_off] == 0):
            prep = prep_section(payload[spec.seq_off : spec.seq_off
                                        + spec.seq_len], ctx)
            if isinstance(prep, int):
                return None
        if prep is None:  # no sequences: the literals are the block
            recs.append(("direct", lit.regenerated, lits, job))
        else:
            recs.append(("seq", lit.regenerated, lits, job, prep))

    seqs = [r for r in recs if r[0] == "seq"]
    if seqs:
        # K7 over every section, then the host resolves the repeat offsets
        ll_d, ml_d, ofv_d, err = decode_sections(
            *pack_sections([r[4] for r in seqs], device))
        if err.any():
            _corrupt()
        ll, ml, ofv = (t.cpu().numpy() for t in (ll_d, ml_d, ofv_d))
        reps = np.array([1, 4, 8], np.int64)
        off = np.empty(len(ll), np.int64)
        s0 = 0
        for r in seqs:
            n = r[4]["nseq"]
            o = lib.resolve_reps(ll[s0 : s0 + n], ofv[s0 : s0 + n], reps)
            if isinstance(o, int):
                _corrupt()
            off[s0 : s0 + n] = o
            s0 += n
    # pass 2: output sizes and offsets, the blocks X1 runs, host pieces
    out_host = np.zeros(max(dsize, 1), np.uint8)
    lit_total = sum(r[1] for r in seqs)
    lit_host = np.zeros(max(lit_total, 1), np.uint8)
    out_patch, lit_patch = [], []
    xblocks = []
    gapped = True
    out_off = lit_off = s0 = 0
    for r in recs:
        kind, size, host, job = r[:4]
        if kind == "seq":
            n = r[4]["nseq"]
            sl = slice(s0, s0 + n)
            out_len = size + int(ml[sl].sum())
            if size < int(ll[sl].sum()) or out_len > BLOCK_MAX:
                _corrupt()
            # match sources, relative to the block start
            src = np.cumsum(ll[sl] + ml[sl].astype(np.int64)) - ml[sl] \
                - off[sl]
            if len(src) and int(src.min()) + out_off < 0:
                _corrupt()  # an offset reaches before the frame
            gapped &= not len(src) or int(src.min()) >= 0
            xblocks.append((out_off, out_len, lit_off, size, s0, n))
            dst, dst_patch, at = lit_host, lit_patch, lit_off
            s0 += n
            lit_off += size
        else:
            out_len = size
            dst, dst_patch, at = out_host, out_patch, out_off
        if out_off + out_len > dsize:
            _corrupt()
        if job is None:
            dst[at : at + size] = host
        else:
            dst_patch.append((4 * job, size, at))
        out_off += out_len
    if out_off != dsize:
        _corrupt()
    out = torch.from_numpy(out_host[:dsize]).to(device)
    lits_d = torch.from_numpy(lit_host[:lit_total]).to(device)
    if jobs:
        rows = _stream_rows(payload, jobs, device)
        _patch(out, rows, out_patch)
        _patch(lits_d, rows, lit_patch)
    if not xblocks:
        return out
    lanes = ([(b, b + 1) for b in range(len(xblocks))] if gapped
             else [(0, len(xblocks))])
    return execute(out, lits_d, ll_d, ml_d,
                   torch.from_numpy(off.astype(np.int32)).to(device),
                   torch.tensor(xblocks, dtype=torch.int64, device=device),
                   torch.tensor(lanes, dtype=torch.int64, device=device),
                   staged=gapped)


def decode_payload_device(payload, dsize: int, device="cuda"):
    """payload: a method 2/3/4/5 superblock payload (a zstd frame and an
    optional sidecar). Returns (dsize,) uint8 on device, or None when its
    headers are not device-decodable (counted in host_ladder; the caller
    asks host libzstd). Raises StenosError when a payload whose headers
    parse is corrupt."""
    global host_ladder
    device = torch.device(device)
    payload = bytes(payload)
    frame_end, entries = split_sidecar(payload)
    parsed = parse_frame(payload, frame_end)
    out = None
    if parsed is not None:
        content, blocks, _ = parsed
        if content is None or content == dsize:
            if entries is not None and len(blocks) == len(entries):
                out = _decode_literals_only(payload, dsize, blocks, entries,
                                            device)
            if out is None:
                out = _decode_blocks(payload, dsize, blocks, entries, device)
    if out is None:
        if not host_ladder:
            warnings.warn("a zstd payload the device decode cannot parse "
                          "goes to host libzstd (device_decode.host_ladder "
                          "counts them)", RuntimeWarning, stacklevel=2)
        host_ladder += 1
    return out
