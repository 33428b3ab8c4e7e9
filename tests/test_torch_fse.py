"""The sequence-section encode (K6) of the port (stenos_tpu_torch, CPU): the
kernel's sync rule (fse_kernel.sync_states) against a walk from every state,
a numpy emulation of csrc/fse_encode.cu's segmented walk against
encode_bitstreams_plain, and the plain version against the JAX package's
encode_sequences_device_batch (interpret mode).

The plain version steps once a sequence, so the blocks here hold at most a
few thousand sequences; the long cases (nseq >= 0x7F00, a block over its
word_cap on the card) are in chip_smoke.py's K6 grid."""

import os

import numpy as np
import pytest
import torch

from stenos_tpu.entropy.fse_pallas import \
    encode_sequences_device_batch as ref_fse_batch
from stenos_tpu.entropy.sequences import \
    encode_sequences as ref_encode_sequences
from stenos_tpu_torch import native
from stenos_tpu_torch.entropy import fse_kernel
from stenos_tpu_torch.entropy.fse import FseEncoder
from stenos_tpu_torch.entropy.match_device import match_candidates
from stenos_tpu_torch.entropy.sequences import (FRESH_REPS, LL_DEFAULT,
                                                LL_LOG, ML_DEFAULT, ML_LOG,
                                                OF_DEFAULT, OF_LOG,
                                                encode_sequences)

TEXT = open(os.path.join(os.path.dirname(__file__), "..", "benchs", "data",
                         "code_text.txt"), "rb").read()
NSYM, STT = fse_kernel.NSYM, fse_kernel.STT


def _text_seqs(n_pieces, size=24_000):
    """The parse (torch match candidates, native parse) of n_pieces
    consecutive text slices of `size` bytes: ~2,000 sequences each."""
    lib = native.load()
    out = []
    for i in range(n_pieces):
        data = np.frombuffer(TEXT[i * size : (i + 1) * size], np.uint8)
        cand = match_candidates(torch.from_numpy(data.copy())[None])[0]
        out.append(lib.match_parse(data, cand.numpy())[0])
    return out


def _mk_seqs(rng, n, lls=20, of_hi=60000):
    return [(int(rng.integers(0, lls)), int(rng.integers(1, of_hi)) + 3,
             int(rng.integers(3, 200))) for _ in range(n)]


def _packed(blocks, reps=FRESH_REPS):
    preps = [fse_kernel.prep_block(s, reps)[1] for s in blocks]
    return fse_kernel.pack_blocks(preps, "cpu")


@pytest.fixture(scope="module")
def text_blocks():
    return _text_seqs(3)


@pytest.fixture(scope="module")
def cases(text_blocks):
    """(name, packed (seqs, tabs, meta), plain words, plain bits) of one
    batch: three text slices, a block whose LL channel has no sync point
    (four literal lengths, uniform), an all-RLE block, one sequence, a small
    block on the predefined tables and one above JAX's 2560-sequence bucket.
    One plain call: its walk is as long as the longest block."""
    rng = np.random.default_rng(5)
    blocks = {f"text{i}": s for i, s in enumerate(text_blocks)}
    blocks["ll_no_sync"] = [(i % 4, int(rng.integers(1, 60000)) + 3,
                             int(rng.integers(3, 200))) for i in range(600)]
    blocks["rle"] = [(7, 64 + 3, 40)] * 300
    blocks["one"] = _mk_seqs(rng, 1)
    blocks["predefined"] = _mk_seqs(rng, 12, lls=8, of_hi=200)
    blocks["past_bucket"] = _mk_seqs(rng, 2600)
    reps = (64, 4, 8)  # the RLE block's offset is a repeat from its start
    packed = _packed(list(blocks.values()), reps)
    words, bits = fse_kernel.encode_bitstreams_plain(*packed)
    return list(blocks), packed, words, bits, reps, blocks


# ------------------------------------------------------------- the sync rule
def _next_from_every_state(dnb, dfs, stt, tl):
    """(64, states) next state of each symbol from every state of the range
    [2^tl, 2^(tl+1)) ([0] for RLE), the kernel's step with its clamps."""
    s = np.arange(1 << tl, 2 << tl) if tl else np.zeros(1, np.int64)
    nb = (s[None] + dnb[:, None]) >> 16
    return stt[np.clip((s[None] >> nb) + dfs[:, None], 0, STT - 1)]


def _check_sync(tabs, meta):
    """sync_states against the walk from every state: every symbol it marks
    has one next state, the one it gives (all 64 symbols); and on the
    table's alphabet (the symbols whose dnb is set; every symbol of an RLE
    channel) it marks every such symbol. Past the alphabet, dnb = dfs = 0
    and the clamp or the zero padding of the state table can make the next
    state one too: no valid code reaches those symbols."""
    got = fse_kernel.sync_states(tabs, meta).numpy()
    t, m = tabs.numpy().astype(np.int64), meta.numpy()
    for b in range(len(m)):
        for ch in range(3):
            dnb, tl = t[b, ch, :NSYM], m[b, 4 + ch]
            nxt = _next_from_every_state(dnb, t[b, ch, NSYM : 2 * NSYM],
                                         t[b, ch, 2 * NSYM :], tl)
            const = (nxt == nxt[:, :1]).all(1)
            mark = got[b, ch] >= 0
            assert (const[mark] & (got[b, ch][mark] == nxt[mark, 0])).all()
            alpha = (dnb != 0) | (tl == 0)
            assert (mark[alpha] == const[alpha]).all(), (b, ch)
    return got


def test_sync_rule_text_tables(cases):
    """On real text blocks' tables (and the other cases' RLE and predefined
    ones) the rule marks exactly the symbols whose next state is the same
    from every state (_check_sync), and they occur in the text: below 20%
    of each channel's codes."""
    names, (seqs, tabs, meta), *_ = cases
    got = _check_sync(tabs, meta)
    m = meta.numpy()
    shares = np.array([[(got[b, ch][seqs.numpy()[m[b, 0] : m[b, 0] + m[b, 1],
                                                  ch]] >= 0).mean()
                        for ch in range(3)]
                       for b, name in enumerate(names)
                       if name.startswith("text")])
    # each channel has sync points in some slice (the offsets of two have
    # none: the walk there is one serial run)
    assert (shares < 0.2).all() and (shares.max(0) > 0).all(), shares
    ll_block = names.index("ll_no_sync")
    rows = seqs.numpy()[m[ll_block, 0] : m[ll_block, 0] + m[ll_block, 1]]
    assert (got[ll_block, 0][rows[:, 0]] < 0).all()
    rle = names.index("rle")
    assert (m[rle, 4:7] == 0).all() and (got[rle] == 0).all()


@pytest.mark.parametrize("norm,log", [(LL_DEFAULT, LL_LOG),
                                      (ML_DEFAULT, ML_LOG),
                                      (OF_DEFAULT, OF_LOG)],
                         ids=["LL", "ML", "OF"])
def test_sync_rule_predefined_tables(norm, log):
    """The predefined LL, ML and OF tables: the rule equals the walk from
    every state (_check_sync), and marks exactly the symbols of count 1 and
    -1."""
    enc = FseEncoder(np.asarray(norm), log)
    tabs = torch.zeros((1, 3, fse_kernel.CHAN), dtype=torch.int32)
    for ch in range(3):
        tabs[0, ch, : len(enc.dnb)] = torch.from_numpy(enc.dnb)
        tabs[0, ch, NSYM : NSYM + len(enc.dfs)] = torch.from_numpy(enc.dfs)
        tabs[0, ch, 2 * NSYM : 2 * NSYM + len(enc.state_table)] = \
            torch.from_numpy(enc.state_table)
    meta = torch.tensor([[0, 1, 0, 1, log, log, log, 0]])
    got = _check_sync(tabs, meta)[0, 0][: len(norm)]
    assert ((got >= 0) == np.isin(norm, (1, -1))).all()


# ------------------------------------------- the kernel's walk, in numpy
class Emit:
    """The kernel's Emit: a segment's bits from bit `off`, as (word, value,
    atomic) stores; the first word is shared with the segment before when
    off is not word-aligned, the last partial one with the segment after."""

    def __init__(self, off):
        self.w, self.nacc, self.acc = off >> 5, off & 31, 0
        self.shared = self.nacc != 0
        self.stores = []

    def put(self, v, nb):
        if nb <= 0:
            return
        self.acc |= (v & ((1 << nb) - 1)) << self.nacc
        self.nacc += nb
        if self.nacc >= 32:
            self.stores.append((self.w, self.acc & 0xFFFFFFFF, self.shared))
            self.shared = False
            self.w += 1
            self.acc >>= 32
            self.nacc -= 32

    def finish(self):
        if self.nacc > 0:
            self.stores.append((self.w, self.acc & 0xFFFFFFFF, True))


def segmented_walk(seqs, tabs, meta, seg_len=None, threads=512, min_seg=8):
    """csrc/fse_encode.cu's passes in numpy, one block at a time: segments
    of seg_len steps (the kernel's max(ceil(n / threads), min_seg) when
    None), A1 (exit states from each segment's first sync point), A2 (one
    walk over each sync-free run), B1 (bit counts, states in range, the
    scan; each walk ends at the exit state A1 or A2 gave) and B2 (each
    segment's words: plain stores only into words no other segment touches,
    OR for the shared first and last). Returns
    (words, bits, the longest sync-free run in segments)."""
    sync = fse_kernel.sync_states(tabs, meta).numpy()
    seqs, tabs, meta = (t.numpy().astype(np.int64) for t in (seqs, tabs,
                                                             meta))
    words = np.zeros(int(meta[:, 3].sum()), np.int64)
    bits = np.zeros(len(meta), np.int64)
    longest = 0
    for b, (off0, n, w0, cap, *tl, _) in enumerate(meta):
        dnb, dfs = tabs[b, :, :NSYM], tabs[b, :, NSYM : 2 * NSYM]
        stt = tabs[b, :, 2 * NSYM :]
        lo = [1 << x if x else 0 for x in tl]
        hi = [(2 << x) - 1 if x else 0 for x in tl]
        rows = seqs[off0 : off0 + n][::-1]  # by step

        def step(ch, s, sym):
            nb = (s + dnb[ch, sym]) >> 16
            idx = (s >> nb) + dfs[ch, sym]
            return int(stt[ch, np.clip(idx, 0, STT - 1)]), int(nb), idx

        def init(ch, sym):
            nb0 = (dnb[ch, sym] + (1 << 15)) >> 16
            v = (nb0 << 16) - dnb[ch, sym]
            return int(stt[ch, np.clip((v >> nb0) + dfs[ch, sym], 0,
                                       STT - 1)])

        L = seg_len or max(-(-n // threads), min_seg)
        S = -(-n // L)
        seg = [range(k * L, min(n, k * L + L)) for k in range(S)]
        # A1
        exit_ = np.full((3, S), -1)
        for k in range(S):
            for ch in range(3):
                s, known = 0, False
                for t in seg[k]:
                    sym = rows[t, ch]
                    if t == 0:
                        s, known = init(ch, sym), True
                    elif known:
                        s = step(ch, s, sym)[0]
                    elif sync[b, ch, sym] >= 0:
                        s, known = int(sync[b, ch, sym]), True
                if known:
                    exit_[ch, k] = s
        # A2: every run's start read before any run is walked
        starts = [(ch, k) for ch in range(3) for k in range(1, S)
                  if exit_[ch, k] < 0 and exit_[ch, k - 1] >= 0]
        for ch, k in starts:
            s, j = exit_[ch, k - 1], k
            while True:
                for t in seg[j]:
                    s = step(ch, s, rows[t, ch])[0]
                exit_[ch, j] = s
                j += 1
                if j == S or exit_[ch, j] >= 0:
                    break
            longest = max(longest, j - k)
        assert (exit_ >= 0).all()

        # B1 and B2: each segment's chunks from its entry states
        def chunks(k):
            s = [int(exit_[ch, k - 1]) if k else 0 for ch in range(3)]
            out = []
            for t in seg[k]:
                r = rows[t]
                if t == 0:
                    s = [init(ch, r[ch]) for ch in range(3)]
                else:
                    for ch in (2, 1, 0):
                        assert lo[ch] <= s[ch] <= hi[ch]
                        nxt, nb, idx = step(ch, s[ch], r[ch])
                        assert 0 <= nb <= 16 and 0 <= idx < STT
                        out.append((s[ch], nb))
                        s[ch] = nxt
                out += [(r[3], r[6]), (r[4], r[7]), (r[5], r[2])]
            # the walk ends at the exit state A1 or A2 gave
            assert s == [int(exit_[ch, k]) for ch in range(3)]
            if k == S - 1:
                out += [(s[1], tl[1]), (s[2], tl[2]), (s[0], tl[0]), (1, 1)]
            return out

        segs = [chunks(k) for k in range(S)]
        offs = np.concatenate([[0], np.cumsum([sum(nb for _, nb in c)
                                               for c in segs])])
        total = int(offs[-1])
        bits[b] = -1 if (total + 31) // 32 > cap else total
        stores = {}
        for k, c in enumerate(segs):
            out = Emit(int(offs[k]))
            for v, nb in c:
                out.put(int(v), int(nb))
            out.finish()
            for w, v, atomic in out.stores:
                stores.setdefault(w, []).append((k, v, atomic))
        for w, st in stores.items():
            # a plain store only into a word no other segment writes
            assert all(atomic for _, _, atomic in st) or len(st) == 1, st
            if w < cap:
                for _, v, _ in st:
                    words[w0 + w] |= v
    words = np.where(words >= 1 << 31, words - (1 << 32), words)
    return words.astype(np.int32), bits, longest


@pytest.mark.parametrize("seg_len", [None, 3, 16, 64])
def test_segmented_walk_equals_plain(cases, seg_len):
    """At the kernel's segment length and at lengths that cut through the
    text blocks' sync-free runs, the segmented walk gives the plain
    version's words and bits: text, a channel with no sync point, RLE
    channels, one sequence, the predefined tables, a block past 2560."""
    names, packed, words, bits, *_ = cases
    got_w, got_b, longest = segmented_walk(*packed, seg_len=seg_len)
    assert (got_b == bits.numpy()).all()
    assert (got_w == words.numpy()).all()
    if seg_len in (3, 16):
        assert longest > 1  # A2 walked runs of several segments


def test_plain_sections_equal_encode_sequences(cases):
    """Within word_cap the plain version's sections equal encode_sequences,
    the port's and the JAX package's host encoder: its report of a block
    over word_cap (bits -1) changes nothing below it."""
    names, packed, words, bits, reps, blocks = cases
    meta = packed[2].numpy()
    w = words.numpy().astype("<u4")
    assert (bits > 0).all()
    for j, name in enumerate(names):
        prefix = fse_kernel.prep_block(blocks[name], reps)[0]
        body = w[meta[j, 2] : meta[j, 2] + meta[j, 3]].tobytes()
        sec = prefix + body[: (int(bits[j]) + 7) // 8]
        assert sec == encode_sequences(blocks[name], reps=reps), name
        assert sec == ref_encode_sequences(blocks[name], reps=reps), name


def test_capacity_report(text_blocks):
    """A block given fewer words than it needs: bits -1 and its first
    word_cap words, in the plain version (the kernel's report); the
    wrapper raises."""
    seqs, tabs, meta = _packed([text_blocks[0][:300], text_blocks[1][:200]])
    words, bits = fse_kernel.encode_bitstreams_plain(seqs, tabs, meta)
    short = meta.clone()
    short[0, 3] = (int(bits[0]) + 31) // 32 - 1
    short[1, 2] = short[0, 3]
    w2, b2 = fse_kernel.encode_bitstreams_plain(seqs, tabs, short)
    assert b2.tolist() == [-1, int(bits[1])]
    cap0 = int(short[0, 3])
    assert torch.equal(w2[:cap0], words[:cap0])
    assert torch.equal(w2[cap0:], words[int(meta[0, 3]):])
    got_w, got_b, _ = segmented_walk(seqs, tabs, short, seg_len=16)
    assert (got_b == b2.numpy()).all() and (got_w == w2.numpy()).all()
    with pytest.raises(RuntimeError, match="word room"):
        fse_kernel.encode_bitstreams(seqs, tabs, short)


def test_plain_equals_pallas():
    """Below JAX's 2560-sequence bucket the port's entry point on the CPU
    gives the Pallas kernel's sections (interpret mode), an RLE block and a
    skipped one included."""
    rng = np.random.default_rng(17)
    blocks = [_mk_seqs(rng, 200), None, [(3, 5 + 3, 20)] * 40,
              _mk_seqs(rng, 90, lls=6, of_hi=100)]
    reps = [FRESH_REPS, None, (5, 9, 1), (64, 4, 8)]
    got = fse_kernel.encode_sequences_device_batch(blocks, reps, "cpu")
    assert got == ref_fse_batch(blocks, reps, interpret=True)
    assert got[1] is None and fse_kernel.launches == 0
