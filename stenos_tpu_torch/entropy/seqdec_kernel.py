"""zstd sequence-section FSE decode: the CUDA kernel (K7) and its plain torch
version.

decode_sections(stream_bytes, meta, tabs, lanes) walks each section's
backward bitstream with its three FSE state machines and returns the RAW
(ll, ml, offset_value) of every sequence, the resolved offsets and a summary
of every section. A lane is the sections of one zstd frame, in order: the
repeat-offset registers start at [1, 4, 8] for each lane and chain across
its sections (native stn_resolve_reps, bit for bit). A CUDA tensor goes
through csrc/seq_decode.cu (it replaces the TPU kernel
stenos_tpu/entropy/seqdec_pallas.py::make_seqdec_kernel), a CPU tensor
through decode_sections_plain, vectorised over sections (then lanes) with a
loop over sequences. Semantics are the TPU kernel's: a read of k bits at
cursor bp yields bits [bp - k, bp), zeros below bit 0 and past the stream;
error bit 1 marks an OF code over 30, bit 2 a stream not consumed exactly,
and bit 4 (the port's own) a repeat offset that resolves to 0 or less (the
registers take it and the walk goes on). The TPU kernel's lanes of 128
sections, chunks of 512 sequences and stream-word buckets were its VMEM
shapes; here any section of a 128 KiB block decodes.

  stream_bytes (nbytes,) uint8  the sections' bitstreams, concatenated;
                          4-byte aligned, nbytes % 4 == 0 (pack_sections)
  meta  (nsec, 8) int64   stream_off, stream_len, bp0 (initial cursor, bits),
                          nseq, seq_off (into the outputs), tl_ll, tl_of,
                          tl_ml
  tabs  (nsec, 1536) int32  decode tables LL | OF | ML, 512 states each,
                          sym | nb << 8 | base << 16 (native zstd_dtables)
  lanes (nlanes, 2) int64  section ranges [s0, s1) that split [0, nsec) in
                          order
  -> ll, ml, ofv, off (total,) int32, total = sum of nseq; summ (nsec, 4)
     int64: sum ll, sum ml, the lowest match source (sum of the lls up to
     and with the sequence's, plus the mls before it, minus its offset:
     relative to the block start; 0 without sequences) and the error bits.
     All on the input's device.
"""

import ctypes

import numpy as np
import torch

from .. import native
from ..ops import _cuda

STATES = 512
META = 8
SUMM = 4
ERR_REPEAT = 4

# code -> (baseline, extra bits), RFC 8878 §3.1.1.3.2.1.1
LL_BASE = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
           16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
           2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
ML_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
           19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
           35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
           2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                      12, 13, 14, 15, 16]

# kernel launches (chip_smoke.py reads this)
launches = 0

_P = ctypes.c_void_p
_SIGNATURES = {"stenos_seq_decode": [_P, _P, _P, _P, ctypes.c_longlong, _P,
                                     _P, _P, _P, _P, _P]}


def prep_section(sec: bytes, ctx):
    """Host O(table) prep of one sequences section: the nseq header, the
    modes and the FSE decode tables (native zstd_dtables; Repeat_Mode
    persists in ctx). Returns a dict, None for zero sequences, or a negative
    error."""
    r = native.load().zstd_dtables(sec, ctx)
    if isinstance(r, int):
        return r
    nseq, meta, tab = r
    if nseq == 0:
        return None
    return {"nseq": nseq, "stream": bytes(sec[int(meta[1]):]),
            "bp0": int(meta[2]),
            "tls": (int(meta[3]), int(meta[4]), int(meta[5])), "tab": tab}


def pack_sections(preps, device, lane_sizes=None):
    """prep_section dicts -> (stream_bytes, meta, tabs, lanes) on device, the
    sequences of section i at [seq_off_i, seq_off_i + nseq_i); lane_sizes:
    sections a lane, in order (default: one lane of all). The stream buffer
    is padded to a multiple of 4 bytes."""
    n = len(preps)
    meta = np.zeros((n, META), np.int64)
    tabs = np.zeros((n, 3 * STATES), np.int32)
    off = seq = 0
    for i, p in enumerate(preps):
        meta[i] = (off, len(p["stream"]), p["bp0"], p["nseq"], seq, *p["tls"])
        tabs[i] = p["tab"]
        off += len(p["stream"])
        seq += p["nseq"]
    buf = np.zeros(max(4, -(-off // 4) * 4), np.uint8)
    buf[:off] = np.frombuffer(b"".join(p["stream"] for p in preps), np.uint8)
    sizes = [n] if lane_sizes is None else list(lane_sizes)
    ends = np.cumsum(sizes, dtype=np.int64)
    lanes = np.stack([ends - sizes, ends], 1).astype(np.int64)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (buf, meta, tabs, lanes.reshape(-1, 2)))


def _windows(stream_bytes, soff, slen):
    """(n, 8 * width + 1) int64: entry q of row i holds bits [q - 32, q) of
    section i's stream as a number (bit q - 32 lowest), zeros below bit 0
    and past the stream; width = the longest stream + 4 bytes."""
    dev = stream_bytes.device
    n = soff.numel()
    width = int(slen.max()) + 4
    col = torch.arange(width, device=dev)
    idx = (soff[:, None] + col).clamp(max=max(stream_bytes.numel() - 1, 0))
    by = torch.where(col < slen[:, None], stream_bytes.long()[idx], 0)
    bits = ((by[:, :, None] >> torch.arange(8, device=dev)) & 1).view(n, -1)
    bits = torch.cat([torch.zeros((n, 32), dtype=torch.int64, device=dev),
                      bits], 1)
    nq = 8 * width + 1
    win = torch.zeros((n, nq), dtype=torch.int64, device=dev)
    for j in range(32):
        win |= bits[:, j : j + nq] << j
    return win


def _walk_plain(stream_bytes, meta, tabs):
    """Every section's state walk side by side, one step a sequence: the raw
    (ll, ml, ofv) and the error bits 1 and 2. A read of k bits at cursor bp
    is entry bp - k + 32 of the section's 32-bit windows, masked."""
    dev = stream_bytes.device
    n = meta.shape[0]
    total = int(meta[:, 3].sum()) if n else 0
    ll_o, ml_o, of_o = (torch.zeros(total, dtype=torch.int32, device=dev)
                        for _ in range(3))
    if n == 0:
        return ll_o, ml_o, of_o, torch.zeros(0, dtype=torch.int32, device=dev)
    soff, slen, bp, nseq, seq_off = (meta[:, i].clone() for i in range(5))
    win = _windows(stream_bytes, soff, slen)
    tab = tabs.long().view(n, 3, STATES)
    c = {name: torch.tensor(v, device=dev) for name, v in (
        ("llb", LL_BASE), ("lln", LL_BITS), ("mlb", ML_BASE),
        ("mln", ML_BITS))}

    def entry(ch, s):
        ok = (s >= 0) & (s < STATES)
        e = torch.gather(tab[:, ch], 1, s.clamp(0, STATES - 1)[:, None])[:, 0]
        return torch.where(ok, e, 0)

    def lookup(t, code):
        ok = code < t.numel()
        return torch.where(ok, t[code.clamp(max=t.numel() - 1)], 0)

    def read(k):
        nonlocal bp
        w = bp - k
        q = (w + 32).clamp(0, win.shape[1] - 1)
        v = torch.gather(win, 1, q[:, None])[:, 0] & ((1 << k) - 1)
        bp = w
        return torch.where(w + k <= 0, 0, v)

    s_ll = read(meta[:, 5])
    s_of = read(meta[:, 6])
    s_ml = read(meta[:, 7])
    err = torch.zeros(n, dtype=torch.int64, device=dev)
    steps = int(nseq.max())
    lls, mls, ofs = (torch.zeros((n, max(steps, 1)), dtype=torch.int64,
                                 device=dev) for _ in range(3))
    for i in range(steps):
        act = (i < nseq).long()
        e_of = entry(1, s_of)
        ofc = (e_of & 255) * act
        err |= torch.where(ofc > 30, 1, 0)
        ofc = ofc.clamp(max=30)
        ofs[:, i] = (1 << ofc) + read(ofc)
        e_ml = entry(2, s_ml)
        mlc = e_ml & 255
        mls[:, i] = lookup(c["mlb"], mlc) + read(lookup(c["mln"], mlc) * act)
        e_ll = entry(0, s_ll)
        llc = e_ll & 255
        lls[:, i] = lookup(c["llb"], llc) + read(lookup(c["lln"], llc) * act)
        upd = (i + 1 < nseq).long()
        s_ll = torch.where(upd == 1, (e_ll >> 16)
                           + read(((e_ll >> 8) & 255) * upd), s_ll)
        s_ml = torch.where(upd == 1, (e_ml >> 16)
                           + read(((e_ml >> 8) & 255) * upd), s_ml)
        s_of = torch.where(upd == 1, (e_of >> 16)
                           + read(((e_of >> 8) & 255) * upd), s_of)
    err |= torch.where((bp != 0) & (nseq > 0), 2, 0)
    keep = torch.arange(lls.shape[1], device=dev) < nseq[:, None]
    dst = (seq_off[:, None] + torch.arange(lls.shape[1], device=dev))[keep]
    for out, vals in ((ll_o, lls), (ml_o, mls), (of_o, ofs)):
        out[dst] = vals[keep].to(torch.int32)
    return ll_o, ml_o, of_o, err.to(torch.int32)


def _resolve_plain(ll, ofv, meta, lanes):
    """Repeat offsets, the lanes side by side, one step a sequence of the
    lane (stn_resolve_reps): (off (total,) int64, the sequences whose offset
    is 0 or less)."""
    dev = ll.device
    m = meta.cpu().numpy()
    nseq, seq_off = m[:, 3], m[:, 4]
    idx = []  # per lane, its sequences in order
    for s0, s1 in lanes.cpu().numpy():
        idx.append(np.concatenate(
            [np.arange(seq_off[s], seq_off[s] + nseq[s])
             for s in range(s0, s1)] + [np.zeros(0, np.int64)]))
    L = max((len(i) for i in idx), default=0)
    g = np.zeros((len(idx), max(L, 1)), np.int64)
    valid = np.zeros_like(g, bool)
    for k, i in enumerate(idx):
        g[k, : len(i)] = i
        valid[k, : len(i)] = True
    g, valid = torch.from_numpy(g).to(dev), torch.from_numpy(valid).to(dev)
    n = len(idx)
    r0, r1, r2 = (torch.full((n,), v, dtype=torch.int64, device=dev)
                  for v in (1, 4, 8))
    off = torch.zeros(ll.numel(), dtype=torch.int64, device=dev)
    bad = torch.zeros(ll.numel(), dtype=torch.bool, device=dev)
    for t in range(L):
        v, q = valid[:, t], g[:, t]
        ov = ofv[q].long()
        ix = ov - 1 + (ll[q] == 0).long()
        new = ov > 3
        o = torch.where(new, ov - 3, torch.where(
            ix == 0, r0, torch.where(ix == 1, r1, torch.where(
                ix == 2, r2, r0 - 1))))
        keep0 = ~new & (ix == 0)  # rep 1: the registers stay
        n1 = torch.where(keep0, r1, r0)
        n2 = torch.where(~new & (ix <= 1), r2, r1)
        r0, r1, r2 = (torch.where(v, a, b) for a, b in
                      ((o, r0), (n1, r1), (n2, r2)))
        off[q[v]] = o[v]
        bad[q[v]] = o[v] <= 0
    return off, bad


def decode_sections_plain(stream_bytes, meta, tabs, lanes):
    """Plain torch version (see the module docstring): the raw walks, then
    the repeat offsets lane by lane and the section summaries."""
    dev = stream_bytes.device
    n = meta.shape[0]
    ll, ml, ofv, err = _walk_plain(stream_bytes, meta, tabs)
    off, bad = _resolve_plain(ll, ofv, meta, lanes)
    summ = torch.zeros((n, SUMM), dtype=torch.int64, device=dev)
    if ll.numel():
        nseq, seq_off = meta[:, 3], meta[:, 4]
        sec = torch.repeat_interleave(torch.arange(n, device=dev), nseq)
        start = torch.repeat_interleave(seq_off, nseq)
        first = torch.repeat_interleave(torch.cumsum(nseq, 0) - nseq, nseq)
        q = start + torch.arange(sec.numel(), device=dev) - first
        lq, mq, oq = ll[q].long(), ml[q].long(), off[q]
        c = torch.cumsum(lq + mq, 0)
        c0 = (c - lq - mq)[first]  # the sums before the section
        src = c - c0 - mq - oq  # relative to the block start
        summ[:, 0].index_add_(0, sec, lq)
        summ[:, 1].index_add_(0, sec, mq)
        summ[:, 2].scatter_reduce_(0, sec, src, "amin", include_self=False)
        err = err.long() | torch.zeros(n, dtype=torch.int64,
                                       device=dev).index_add_(
            0, sec, bad[q].long()).clamp(max=1) * ERR_REPEAT
    summ[:, 3] = err
    return ll, ml, ofv, off.to(torch.int32), summ


def decode_sections(stream_bytes, meta, tabs, lanes):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring)."""
    global launches
    if stream_bytes.device.type == "cpu":
        return decode_sections_plain(stream_bytes, meta, tabs, lanes)
    dev = stream_bytes.device
    n = meta.shape[0]
    nl = lanes.shape[0]
    for name, t, dtype, shape in (
            ("stream_bytes", stream_bytes, torch.uint8,
             (stream_bytes.numel(),)),
            ("meta", meta, torch.int64, (n, META)),
            ("tabs", tabs, torch.int32, (n, 3 * STATES)),
            ("lanes", lanes, torch.int64, (nl, 2))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"decode_sections: {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {dev}")
    if (dev.type != "cuda" or stream_bytes.numel() % 4
            or stream_bytes.data_ptr() % 4):
        raise ValueError(f"decode_sections: unsupported device {dev}, or a "
                         "stream buffer that is not 4-byte aligned and a "
                         "multiple of 4 bytes")
    total = int(meta[:, 3].sum()) if n else 0
    outs = [torch.empty(total, dtype=torch.int32, device=dev)
            for _ in range(4)]
    summ = torch.empty((n, SUMM), dtype=torch.int64, device=dev)
    if nl:
        lib = _cuda.load("seq_decode", _SIGNATURES)
        _cuda.check(lib.stenos_seq_decode(
            stream_bytes.data_ptr(), meta.data_ptr(), tabs.data_ptr(),
            lanes.data_ptr(), nl, *(o.data_ptr() for o in outs),
            summ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), "seq_decode")
        launches += 1
    return (*outs, summ)
