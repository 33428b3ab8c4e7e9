"""zstd sequence-section FSE encode: the CUDA kernel (K6), its plain torch
version, and the batched section encoder around them (the port of
stenos_tpu/entropy/fse_pallas.py's prep_block, encode_seq_bitstreams_device
and encode_sequences_device_batch).

encode_bitstreams(seqs, tabs, meta) writes each block's sequence bitstream,
BitWriter-identical to sequences.encode_sequences (terminator and padding
included): the three interleaved LL/OF/ML FSE states walked from the last
sequence to the first, with each sequence's extra bits, in the chunk order
of fse_pallas.py:82-88. A CUDA tensor goes through csrc/fse_encode.cu (it
replaces the TPU kernel stenos_tpu/entropy/fse_pallas.py::make_fse_kernel),
a CPU tensor through encode_bitstreams_plain: the state walks side by side,
one step a sequence, then the chunks placed at the exclusive sum of their
bit counts. The kernel cuts each block's walk into segments and breaks the
state chains at sync points (sync_states: a symbol after which the state is
the same from every state), so that many threads walk a block. The TPU
kernel's bucket of at most 2560 sequences a block (a
VMEM limit) is gone: the kernel takes up to 49,152 sequences a block (a
zstd block of 128 KiB holds at most 43,690), and where the JAX entry point
returns None the section here equals encode_sequences(seqs, reps=reps).

  seqs  (N, 8) int32   per sequence, natural order: ll_sym, ml_sym, of_sym,
                       ll_x, ml_x, of_x, ll_nb, ml_nb (of_nb = of_sym)
  tabs  (nblk, 3, 640) int32  per channel LL, ML, OF: dnb[64], dfs[64],
                       state table[512]
  meta  (nblk, 8) int64  seq_off, nseq (>= 1), word_off, word_cap, tl_ll,
                       tl_ml, tl_of, 0
  -> words (sum of word_cap,) int32, zero past each block's bits;
     bits (nblk,) int64; on the input's device. A block that needs more
     than word_cap words has bits -1 and its first word_cap words written;
     the wrapper raises on it.

This entry point is the port's counterpart of the JAX package's; like it,
nothing in frame.compress reaches it.
"""

import ctypes

import numpy as np
import torch

from .. import native
from ..ops import _cuda
from .sequences import (LL_DEFAULT, LL_LOG, LL_TABLE, ML_DEFAULT, ML_LOG,
                        ML_TABLE, OF_DEFAULT, OF_LOG, _channel_plan_syms,
                        _RleEncoder)

NSYM = 64
STT = 512
CHAN = 2 * NSYM + STT
COLS = 8
META = 8

# kernel launches (chip_smoke.py reads this)
launches = 0

_P = ctypes.c_void_p
_SIGNATURES = {"stenos_fse_encode": [_P, _P, _P, ctypes.c_longlong, _P, _P,
                                     _P]}


def _chan_prep(syms, default_norm, default_log, max_log):
    """(mode, header bytes, (dnb, dfs, state table, table_log)) of one
    channel's codes."""
    mode, hdr, fac = _channel_plan_syms(syms, default_norm, default_log,
                                        max_log)
    enc = fac()
    if isinstance(enc, _RleEncoder):
        z = np.zeros(1, np.int64)
        return mode, hdr, (z, z, z, 0)
    return mode, hdr, (np.asarray(enc.dnb, np.int64),
                       np.asarray(enc.dfs, np.int64),
                       np.asarray(enc.state_table, np.int64), enc.table_log)


def _codes(vals, lo, shift, first, table):
    """Vectorised code and extra-bit count of lengths: a value below lo is
    code value - shift with no extra bits, the others take codes first + i
    of the (baseline, extra bits) table."""
    codes = np.where(vals < lo, vals - shift, 0)
    nbs = np.zeros_like(vals)
    big = vals >= lo
    if big.any():
        bases = np.asarray([b for b, _ in table], np.int64)
        nbt = np.asarray([nb for _, nb in table], np.int64)
        idx = np.searchsorted(bases + (np.int64(1) << nbt), vals[big],
                              side="right")
        codes[big] = first + idx
        nbs[big] = nbt[idx]
    return codes, nbs


def prep_block(seqs, reps=(1, 4, 8)):
    """encode_sequences up to the bitstream: (prefix bytes, prep) where the
    prefix is the nseq header, the modes byte and the NCount descriptions
    and prep feeds the bitstream encode (None for zero sequences). seqs: a
    list of (ll, offset_value, ml) or an (n, 3) array; the repeat-offset
    chain runs natively (stn_recode_reps_enc), the rest is numpy."""
    arr = np.asarray(seqs, np.int64).reshape(-1, 3)
    n = len(arr)
    out = bytearray()
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        out.append((n >> 8) + 128)
        out.append(n & 255)
    else:
        out += bytes([255, (n - 0x7F00) & 255, (n - 0x7F00) >> 8])
    if n == 0:
        return bytes(out), None
    lls, mls = arr[:, 0], arr[:, 2]
    ofs = native.load().recode_reps_enc(lls, arr[:, 1],
                                        np.asarray(reps, np.int64).copy())
    if isinstance(ofs, int):
        raise ValueError(f"bad offset_value stream ({ofs})")
    ofs = ofs.astype(np.int64)
    ll_sym, ll_nb = _codes(lls, 16, 0, 16, LL_TABLE)
    ml_sym, ml_nb = _codes(mls, 35, 3, 32, ML_TABLE)
    # of_code = highbit(offset_value); frexp is exact below 2^53
    of_sym = (np.frexp(ofs.astype(np.float64))[1] - 1).astype(np.int64)
    ll_m, ll_h, ll_t = _chan_prep(ll_sym, LL_DEFAULT, LL_LOG, 9)
    of_m, of_h, of_t = _chan_prep(of_sym, OF_DEFAULT, OF_LOG, 8)
    ml_m, ml_h, ml_t = _chan_prep(ml_sym, ML_DEFAULT, ML_LOG, 9)
    out.append((ll_m << 6) | (of_m << 4) | (ml_m << 2))
    out += ll_h + of_h + ml_h
    cols = np.stack([ll_sym, ml_sym, of_sym, lls, mls - 3,
                     ofs - (np.int64(1) << of_sym), ll_nb, ml_nb], 1)
    return bytes(out), {"nseq": n, "seqs": cols.astype(np.int32),
                        "tabs": (ll_t, ml_t, of_t)}


def pack_blocks(preps, device):
    """prep dicts -> (seqs, tabs, meta) on device, each block's words at
    word_off with room for its worst case: its extra and flush bits, the
    terminator and 30 state bits a sequence."""
    n = len(preps)
    tabs = np.zeros((n, 3, CHAN), np.int32)
    meta = np.zeros((n, META), np.int64)
    seq_off = word_off = 0
    for i, p in enumerate(preps):
        s = p["seqs"]
        for ch, (dnb, dfs, stt, _) in enumerate(p["tabs"]):
            tabs[i, ch, : len(dnb)] = dnb
            tabs[i, ch, NSYM : NSYM + len(dfs)] = dfs
            tabs[i, ch, 2 * NSYM : 2 * NSYM + len(stt)] = stt
        tls = [t[3] for t in p["tabs"]]
        bound = (int(s[:, 6].sum() + s[:, 7].sum() + s[:, 2].sum())
                 + sum(tls) + 1 + 30 * (p["nseq"] - 1))
        cap = bound // 32 + 2
        meta[i] = (seq_off, p["nseq"], word_off, cap, *tls, 0)
        seq_off += p["nseq"]
        word_off += cap
    seqs = np.concatenate([p["seqs"] for p in preps]) if preps else \
        np.zeros((0, COLS), np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (seqs, tabs, meta))


def sync_states(tabs, meta):
    """The kernel's sync rule, (nblk, 3, 64) int64: for each channel (LL,
    ML, OF) and symbol, the next state after that symbol when its table
    index (state >> nb) + dfs is the same from every state of the channel's
    range [2^tl, 2^(tl+1)) ([0, 0] for an RLE channel, tl 0), else -1. The
    test: nb = (state + dnb) >> 16 and state >> nb equal at both ends of the
    range (nb is monotone in the state, and so is state >> nb for one nb).
    In an FSE table it holds for the symbols of normalized count 1 or -1
    (nb = tl, state >> nb = 1) and the absent ones."""
    tl = meta[:, 4:7].long()
    lo = torch.where(tl > 0, 1 << tl, 0)[:, :, None]
    hi = torch.where(tl > 0, (2 << tl) - 1, 0)[:, :, None]
    t = tabs.long()
    dnb, dfs = t[:, :, :NSYM], t[:, :, NSYM : 2 * NSYM]
    stt = t[:, :, 2 * NSYM :]
    nl, nh = (lo + dnb) >> 16, (hi + dnb) >> 16
    ok = (nl == nh) & (nl >= 0) & (nl < 16)
    sh = nl.clamp(0, 15)
    ok &= (lo >> sh) == (hi >> sh)
    nxt = torch.gather(stt, 2, ((lo >> sh) + dfs).clamp(0, STT - 1))
    return torch.where(ok, nxt, -1)


def encode_bitstreams_plain(seqs, tabs, meta):
    """Plain torch version (see the module docstring)."""
    dev = seqs.device
    nb_ = meta.shape[0]
    words = torch.zeros(int(meta[:, 3].sum()) if nb_ else 0,
                        dtype=torch.int32, device=dev)
    bits = torch.zeros(nb_, dtype=torch.int64, device=dev)
    if nb_ == 0:
        return words, bits
    seq_off, nseq = meta[:, 0], meta[:, 1]
    T = int(nseq.max())
    t = torch.arange(T, device=dev)
    # column t of block b: sequence n_b - 1 - t (reverse order)
    idx = (seq_off[:, None] + nseq[:, None] - 1 - t).clamp(min=0)
    live = (t < nseq[:, None]).long()
    col = seqs.long()[idx] * live[:, :, None]   # (nblk, T, 8)
    tab = tabs.long()

    def look(ch, base, i):
        return torch.gather(tab[:, ch], 1, (base + i)[:, None])[:, 0]

    def init(ch, sym):
        dnb = look(ch, 0, sym.clamp(0, NSYM - 1))
        dfs = look(ch, NSYM, sym.clamp(0, NSYM - 1))
        nb0 = (dnb + (1 << 15)) >> 16
        v = (((nb0 << 16) - dnb) & 0xFFFFFFFF) >> nb0
        return look(ch, 2 * NSYM, (v + dfs).clamp(0, STT - 1))

    # chunk rows: 3 extras, 6 a step t = 1..T-1, 3 flush, 1 terminator
    R = 3 + 6 * (T - 1) + 4
    val = torch.zeros((nb_, R), dtype=torch.int64, device=dev)
    nbs = torch.zeros((nb_, R), dtype=torch.int64, device=dev)
    c0 = col[:, 0]
    val[:, 0:3] = c0[:, 3:6]
    nbs[:, 0:3] = torch.stack([c0[:, 6], c0[:, 7], c0[:, 2]], 1)
    states = [init(ch, c0[:, ch]) for ch in range(3)]  # LL, ML, OF
    for step in range(1, T):
        act = live[:, step]
        c = col[:, step]
        base = 3 + 6 * (step - 1)
        for slot, ch in enumerate((2, 1, 0)):  # OF, ML, LL states
            s = states[ch]
            sym = c[:, ch].clamp(0, NSYM - 1)
            nb = (s + look(ch, 0, sym)) >> 16
            val[:, base + slot] = s
            nbs[:, base + slot] = nb * act
            ns = look(ch, 2 * NSYM, ((s >> nb) + look(ch, NSYM, sym)).clamp(
                0, STT - 1))
            states[ch] = torch.where(act == 1, ns, s)
        val[:, base + 3 : base + 6] = c[:, 3:6]
        nbs[:, base + 3 : base + 6] = torch.stack([c[:, 6], c[:, 7],
                                                   c[:, 2]], 1)
    fb = R - 4
    val[:, fb : fb + 3] = torch.stack([states[1], states[2], states[0]], 1)
    nbs[:, fb : fb + 3] = meta[:, [5, 6, 4]]
    val[:, fb + 3] = 1
    nbs[:, fb + 3] = 1
    v = val & ((1 << nbs) - 1)
    incl = torch.cumsum(nbs, 1)
    off = incl - nbs
    sh = off & 31
    need = (incl[:, -1] + 31) >> 5
    cap = int(meta[:, 3].max())
    acc = torch.zeros((nb_, max(cap, int(need.max())) + 1),
                      dtype=torch.int64, device=dev)
    acc.scatter_add_(1, off >> 5, (v << sh) & 0xFFFFFFFF)
    acc.scatter_add_(1, (off >> 5) + 1, v >> (32 - sh))
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    bits = torch.where(need > meta[:, 3], -1, incl[:, -1])
    keep = torch.arange(cap, device=dev) < meta[:, 3:4]
    words[...] = acc[:, :cap][keep].to(torch.int32)
    return words, bits


def encode_bitstreams(seqs, tabs, meta):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring). Raises when a block outgrows its
    word_cap (RuntimeError), or holds what the kernel does not take
    (ValueError, encode_bitstreams_cuda)."""
    if seqs.device.type == "cpu":
        words, bits = encode_bitstreams_plain(seqs, tabs, meta)
    else:
        words, bits = encode_bitstreams_cuda(seqs, tabs, meta)
    low = int(bits.min()) if bits.numel() else 0
    if low == -2:
        raise ValueError("fse_encode: a table, code or state out of the "
                         "kernel's range, or a block over 49,152 "
                         "sequences")
    if low < 0:
        raise RuntimeError("fse_encode: a block outgrew its word room")
    return words, bits


def encode_bitstreams_cuda(seqs, tabs, meta):
    """The kernel's launch: words and bits as the plain version gives them
    (bits -1 where a block outgrows word_cap), or bits -2 where a block
    holds what the kernel does not take: an FSE table's states lie in
    [2^tl, 2^(tl+1)) and its indexes in the table, tl <= 9, symbol codes
    below 64 (offset codes below 32), extra-bit counts at most 32, at
    most 49,152 sequences a block."""
    global launches
    dev = seqs.device
    nb_ = meta.shape[0]
    for name, t, dtype, shape in (
            ("seqs", seqs, torch.int32, (seqs.shape[0], COLS)),
            ("tabs", tabs, torch.int32, (nb_, 3, CHAN)),
            ("meta", meta, torch.int64, (nb_, META))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"encode_bitstreams: {name} must be a "
                             f"contiguous {shape} {dtype} tensor on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"encode_bitstreams: unsupported device {dev}")
    if seqs.data_ptr() % 16:
        raise ValueError("encode_bitstreams: seqs must be 16-byte aligned")
    words = torch.zeros(int(meta[:, 3].sum()) if nb_ else 0,
                        dtype=torch.int32, device=dev)
    bits = torch.zeros(nb_, dtype=torch.int64, device=dev)
    if nb_:
        lib = _cuda.load("fse_encode", _SIGNATURES)
        _cuda.check(lib.stenos_fse_encode(
            seqs.data_ptr(), tabs.data_ptr(), meta.data_ptr(), nb_,
            words.data_ptr(), bits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "fse_encode")
        launches += 1
    return words, bits


def encode_sequences_device_batch(seq_blocks, reps_list, device="cuda"):
    """The batched section encoder: seq_blocks is a list of sequence lists
    ((ll, offset_value, ml), or None to skip), reps_list the running
    repeat-offset registers at each block's entry. Returns the section bytes
    of each block (None where skipped), equal to
    sequences.encode_sequences(seqs, reps=reps); the bitstreams of all
    blocks come from one encode_bitstreams call on device."""
    out = [None] * len(seq_blocks)
    todo = []
    for i, (seqs, reps) in enumerate(zip(seq_blocks, reps_list)):
        if seqs is None:
            continue
        prefix, prep = prep_block(seqs, reps)
        out[i] = prefix
        if prep is not None:
            todo.append((i, prep))
    if not todo:
        return out
    packed = pack_blocks([p for _, p in todo], torch.device(device))
    words, bits = encode_bitstreams(*packed)
    words = words.cpu().numpy().astype("<u4")
    bits = bits.cpu().numpy()
    meta = packed[2].cpu().numpy()
    for j, (i, _) in enumerate(todo):
        w0 = int(meta[j, 2])
        nbytes = (int(bits[j]) + 7) // 8
        out[i] += words[w0 : w0 + int(meta[j, 3])].tobytes()[:nbytes]
    return out
