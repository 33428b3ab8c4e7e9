"""The port's device zstd entropy stage (stenos_tpu_torch, CPU) against the
JAX package: the sequence decode (K7), sequence encode (K6) and sequence
executor (X1) plain versions, the device match candidates, the device frame
encoder, decode_payload_device and the frame layer with entropy="device".
Exact bytes everywhere.

STENOS_DEVICE_MATCH is pinned on both sides of every frame comparison: the
frame bytes depend on the match route, and unset the JAX package routes by
a host-link probe that the port does not copy.

Interpret-mode Pallas and the plain sequence walks are slow, so the inputs
are small (at most a few thousand sequences a section) and the JAX results
that several tests share are computed once per module."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import zstandard

from stenos_tpu import frame as ref_frame
from stenos_tpu.entropy import device_decode as ref_decode
from stenos_tpu.entropy import match_device as ref_match
from stenos_tpu.entropy import seq_exec as ref_exec
from stenos_tpu.entropy import zstd_frame as ref_zstd_frame
from stenos_tpu.entropy.fse_pallas import \
    encode_sequences_device_batch as ref_fse_batch
from stenos_tpu.entropy.seqdec_pallas import decode_sections_device
from stenos_tpu.entropy.seqdec_pallas import prep_section as ref_prep
from stenos_tpu.native import lib as ref_lib
from stenos_tpu_torch import frame, native
from stenos_tpu_torch.engine import TorchEngine
from stenos_tpu_torch.entropy import (device_decode, fse_kernel, seq_exec,
                                      seqdec_kernel, zstd_frame)
from stenos_tpu_torch.entropy.match_device import (match_candidates,
                                                   matchiness)
from stenos_tpu_torch.entropy.sequences import FRESH_REPS, encode_sequences
from stenos_tpu_torch.entropy.zstd_parse import parse_frame

BLOCK = 131072
TEXT = open(os.path.join(os.path.dirname(__file__), "..", "benchs", "data",
                         "code_text.txt"), "rb").read()
lib = native.load()


def _u8(b):
    return np.frombuffer(bytes(b), np.uint8)


def _sections(frame_bytes):
    """The non-empty sequences sections of a zstd frame, in block order."""
    end = len(frame_bytes)
    _, blocks, _ = parse_frame(frame_bytes, end)
    return [frame_bytes[s.seq_off : s.seq_off + s.seq_len] for s in blocks
            if s.btype == 2 and s.seq_len and frame_bytes[s.seq_off] != 0]


def _mk_seqs(rng, n, style):
    """tests/test_fse_pallas.py's sequence generator."""
    seqs = []
    for i in range(n):
        ll = int(rng.integers(0, 20)) if style != "ll0" else 0
        of = 64 if style == "rep" and i % 3 else int(rng.integers(1, 60000))
        seqs.append((ll, of + 3, int(rng.integers(3, 200))))
    return seqs


@pytest.fixture(scope="module")
def blocks3():
    """Three full blocks (literals, 64-byte records, text) and a partial
    tail: every route of encode_frame_device."""
    rng = np.random.default_rng(2)
    lit = rng.integers(0, 64, BLOCK).astype(np.uint8)
    rec = np.tile(rng.integers(0, 256, 64).astype(np.uint8), BLOCK // 64)
    return np.concatenate([lit, rec, _u8(TEXT[:BLOCK]), lit[:5000]])


@pytest.fixture(scope="module")
def ref_frames(blocks3):
    """JAX encode_frame_device (interpret mode) of blocks3 under both
    STENOS_DEVICE_MATCH settings."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for dm in ("0", "1"):
            mp.setenv("STENOS_DEVICE_MATCH", dm)
            out[dm] = ref_zstd_frame.encode_frame_device(blocks3,
                                                         interpret=True)
    return out


# ------------------------------------------------------- K7 sequence decode
def _decode_chain(secs):
    """K7's plain version over secs (one lane, tables chained in order):
    (raw triples, offsets) a section; its offsets equal the native
    resolve_reps of its raw triples, chained across the sections."""
    ctx = lib.zstd_ctx()
    preps = [seqdec_kernel.prep_section(s, ctx) for s in secs]
    ll, ml, ofv, off, summ = seqdec_kernel.decode_sections(
        *seqdec_kernel.pack_sections(preps, "cpu"))
    assert not summ[:, 3].any()
    reps = np.array([1, 4, 8], np.int64)
    out, s0 = [], 0
    for p in preps:
        n = p["nseq"]
        raw = tuple(t[s0 : s0 + n].numpy() for t in (ll, ml, ofv))
        out.append((raw, lib.resolve_reps(raw[0], raw[2], reps)))
        assert (off[s0 : s0 + n].numpy() == out[-1][1]).all()
        s0 += n
    return out, reps


@pytest.mark.parametrize("source", ["zstd1", "zstd19", "zstd7_chain",
                                    "native"])
def test_seq_decode_plain_matches_native(source):
    """K7's plain version equals the native raw walk (stn_zstd_seqs_raw),
    and resolve_reps of it equals stn_zstd_seqs, with the Repeat_Mode tables
    and the registers chained across blocks."""
    rng = np.random.default_rng(7)
    if source == "native":
        recs = rng.integers(0, 50, (3000, 3)).astype(np.uint8)
        recs[:, 0] = np.arange(3000) % 97
        f = zstd_frame.encode_frame_device(np.tile(recs.reshape(-1), 16),
                                           device="cpu")
    elif source == "zstd7_chain":
        piece = b"abcdefgh" * 5000 + rng.integers(0, 16, 40_000,
                                                  np.uint8).tobytes()
        f = zstandard.ZstdCompressor(level=7).compress(piece * 4)
    else:
        data = (TEXT[:12_000]
                + np.repeat(rng.integers(0, 6, 800, np.uint8),
                            rng.integers(1, 90, 800)).tobytes())
        f = zstandard.ZstdCompressor(level=int(source[4:])).compress(data)
    secs = _sections(f)
    assert secs
    got, reps = _decode_chain(secs)
    ctx_r, ctx_s = ref_lib.zstd_ctx(), ref_lib.zstd_ctx()
    reps_w = np.array([1, 4, 8], np.int64)
    for sec, (raw, off) in zip(secs, got):
        want_raw = ref_lib.zstd_seqs_raw(sec, ctx_r)
        want = ref_lib.zstd_seqs(sec, reps_w, ctx_s)
        for a, b in zip(raw, want_raw):
            assert (a == b).all()
        assert (raw[0] == want[0]).all() and (raw[1] == want[1]).all()
        assert (off == want[2]).all()
    assert (reps == reps_w).all()


def test_seq_decode_plain_matches_pallas():
    f = zstandard.ZstdCompressor(level=3).compress(TEXT[:3000])
    sec = _sections(f)[0]
    want = decode_sections_device([ref_prep(sec, ref_lib.zstd_ctx())],
                                  interpret=True)[0]
    p = seqdec_kernel.prep_section(sec, lib.zstd_ctx())
    ll, ml, ofv, _, summ = seqdec_kernel.decode_sections(
        *seqdec_kernel.pack_sections([p], "cpu"))
    assert summ[:, 3].tolist() == [0] and seqdec_kernel.launches == 0
    for a, b in zip((ll, ml, ofv), want):
        assert (a.numpy() == b).all()


def test_seq_decode_flags_corrupt_section():
    """One sequence more than the stream holds: the stream is not consumed
    exactly, error bit 2 (the Pallas kernel returns None there)."""
    f = zstandard.ZstdCompressor(level=3).compress(TEXT[:4000])
    sec = _sections(f)[0]
    p = seqdec_kernel.prep_section(sec, lib.zstd_ctx())
    p["nseq"] += 1
    err = seqdec_kernel.decode_sections(
        *seqdec_kernel.pack_sections([p], "cpu"))[4][:, 3]
    assert err.tolist() == [2]
    q = ref_prep(sec, ref_lib.zstd_ctx())
    q["nseq"] += 1
    assert decode_sections_device([q], interpret=True) == [None]


# ------------------------------------------------------- K6 sequence encode
def test_fse_encode_plain_matches_pallas():
    """In the Pallas kernel's bucket: sections equal its, batch and skips
    included."""
    rng = np.random.default_rng(9)
    blocks = [_mk_seqs(rng, 1, "x"), None, _mk_seqs(rng, 2, "rep"),
              _mk_seqs(rng, 63, "ll0"), _mk_seqs(rng, 200, "rep")]
    reps = [FRESH_REPS, None, (64, 1, 4), (7, 64, 1), FRESH_REPS]
    got = fse_kernel.encode_sequences_device_batch(blocks, reps, "cpu")
    want = ref_fse_batch(blocks, reps, interpret=True)
    assert got == want and got[1] is None
    assert fse_kernel.launches == 0


@pytest.mark.parametrize("n,style", [(2561, "x"), (3000, "rep")])
def test_fse_encode_plain_past_bucket(n, style):
    """Past the Pallas bucket (T > 2560, where its entry returns None) the
    section equals encode_sequences, the bytes its callers fall back to."""
    rng = np.random.default_rng(n)
    seqs = _mk_seqs(rng, n, style)
    reps = (64, 128, 4)
    assert ref_fse_batch([seqs], [reps], interpret=True) == [None]
    got = fse_kernel.encode_sequences_device_batch([seqs], [reps], "cpu")
    assert got[0] == encode_sequences(seqs, reps=reps)


def test_fse_encode_sections_decode_back():
    """Sections of a real parse decode through K7 and resolve_reps to the
    parse's own sequences."""
    data = _u8(TEXT[:20_000])
    cand = match_candidates(torch.from_numpy(data.copy())[None])[0].numpy()
    seqs, _ = lib.match_parse(data, cand)
    sec = fse_kernel.encode_sequences_device_batch([seqs], [FRESH_REPS],
                                                   "cpu")[0]
    assert sec == encode_sequences(seqs, reps=FRESH_REPS)
    (raw, off), = _decode_chain([sec])[0]
    arr = np.asarray(seqs)
    assert (raw[0] == arr[:, 0]).all() and (raw[1] == arr[:, 2]).all()
    assert (off == arr[:, 1] - 3).all()


# ------------------------------------------------------- X1 sequence exec
def _jax_programs_run(out, lits, ll, ml, off, blocks, lanes, gapped):
    """The same sequences through the JAX package's programs (native
    seq_ops, pack_programs, run_programs_numpy) in its own layouts: literal
    area first, then one row of BLOCK + W a block (gapped) or the dense
    output with the other blocks riding copy ops (gapless). blocks: X1's
    first 6 columns, every literal in lits."""
    W = ref_decode.W
    row = BLOCK + W
    out, lits = out.numpy(), lits.numpy()
    ll, ml, off, blocks = (t.numpy() for t in (ll, ml, off, blocks))
    lit_total = len(lits) + (0 if gapped else len(out))
    progs, cur = [], 0
    if not gapped:  # the bytes outside the sequence blocks, as copy ops
        covered = np.zeros(len(out), bool)
        for b in blocks:
            covered[b[0] : b[0] + b[1]] = True
    for i, (o_off, o_len, l_off, l_len, s_off, n) in enumerate(blocks):
        if not gapped and cur < o_off:
            cs = np.arange(cur, o_off, W)
            progs.append(np.stack([lit_total + cs, len(lits) + cs], 1))
        boff = lit_total + (i * row if gapped else o_off)
        sl = slice(s_off, s_off + n)
        ops = ref_lib.seq_ops(ll[sl], ml[sl], off[sl].astype(np.int64), boff,
                              l_off, l_len - int(ll[sl].sum()), boff + o_len,
                              W)
        progs.append(ops[:, :2])
        cur = o_off + o_len
    if not gapped:
        if cur < len(out):
            cs = np.arange(cur, len(out), W)
            progs.append(np.stack([lit_total + cs, len(lits) + cs], 1))
        progs = [np.concatenate(progs)]
    buf_len = lit_total + (len(blocks) * row if gapped else len(out))
    dst, src, total = ref_exec.pack_programs(progs, buf_len, W)
    stage = np.zeros(total, np.uint8)
    stage[: len(lits)] = lits
    if not gapped:
        stage[len(lits) : len(lits) + len(out)] = np.where(covered, 0, out)
    buf = ref_exec.run_programs_numpy(stage, dst, src, W)
    res = out.copy()
    for i, (o_off, o_len, *_) in enumerate(blocks):
        start = lit_total + (i * row if gapped else o_off)
        res[o_off : o_off + o_len] = buf[start : start + o_len]
    if not gapped:
        res = buf[lit_total : lit_total + len(out)]
    return res


@pytest.mark.parametrize("gapped", [True, False])
def test_seq_exec_plain_matches_programs(gapped, monkeypatch):
    """X1's plain version against the JAX package's executor on the inputs
    decode_payload_device hands X1: our encoder's blocks (one lane a block)
    and a libzstd frame with matches across blocks, behind a raw block (one
    ordered lane)."""
    rng = np.random.default_rng(4)
    if gapped:
        rec = np.tile(rng.integers(0, 256, 64).astype(np.uint8), BLOCK // 64)
        data = np.concatenate([rec, _u8(TEXT[:9000])])
        payload = zstd_frame.encode_frame_device(data, device="cpu")
    else:
        piece = rng.integers(0, 256, 90_000, np.uint8).tobytes()
        data = _u8(piece * 3 + TEXT[:3000])
        payload = zstandard.ZstdCompressor(level=9).compress(data.tobytes())
    calls = []
    real = seq_exec.execute

    def spy(out, *rest):
        calls.append((out.clone(), *rest))
        return real(out, *rest)

    monkeypatch.setattr(device_decode, "execute", spy)
    got = device_decode.decode_payload_device(payload, len(data), "cpu")
    assert got is not None and np.array_equal(got.numpy(), data)
    (out, lits, rows, ll, ml, off, blocks, lanes), = calls
    assert len(lanes) == (len(blocks) if gapped else 1)
    assert bool(lanes[:, 2].any()) == gapped and len(blocks) >= 2
    plain = seq_exec.execute_plain(out.clone(), lits, rows, ll, ml, off,
                                   blocks, lanes)
    lits, blocks = seq_exec.gather_literals(lits, rows, blocks)
    want = _jax_programs_run(out, lits, ll, ml, off, blocks[:, :6], lanes,
                             gapped)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(plain.numpy(), data)


# --------------------------------------------------------- match candidates
def test_match_candidates_and_matchiness_match_jax(blocks3):
    blocks = blocks3[: 3 * BLOCK].reshape(3, BLOCK)
    x = torch.from_numpy(blocks.copy())
    assert np.array_equal(match_candidates(x).numpy(),
                          ref_match.match_candidates(blocks))
    got = matchiness(x)
    assert got.dtype == np.float32
    assert np.array_equal(got, ref_match.matchiness(blocks))


# --------------------------------------------------------- frame encoder
@pytest.mark.parametrize("dm", ["0", "1"])
def test_encode_frame_device_matches_jax(blocks3, ref_frames, dm,
                                         monkeypatch):
    monkeypatch.setenv("STENOS_DEVICE_MATCH", dm)
    got = zstd_frame.encode_frame_device(blocks3, device="cpu")
    assert got == ref_frames[dm]
    assert zstandard.ZstdDecompressor().decompress(
        got, max_output_size=len(blocks3)) == blocks3.tobytes()


def test_route_changes_frame_bytes(ref_frames):
    """Why the tests pin STENOS_DEVICE_MATCH: the two routes give other
    (valid) frames."""
    assert ref_frames["0"] != ref_frames["1"]


def test_encode_frame_device_empty_and_tail():
    for n in (0, 100, 70_000):
        data = _u8(TEXT[:n])
        got = zstd_frame.encode_frame_device(data, device="cpu")
        assert got == ref_zstd_frame.encode_frame_device(data,
                                                         interpret=True)


# --------------------------------------------------------- payload decode
@pytest.fixture(scope="module")
def payloads():
    """(name, payload, data) for the decode tiers: an all-literals device
    frame (tier 1), a device frame with sequences and anchors in its
    sidecar (tier 2), libzstd frames at stenos levels 2 and 9 (foreign)."""
    rng = np.random.default_rng(5)
    lit = rng.integers(0, 64, BLOCK).astype(np.uint8)
    mixed = np.concatenate([lit, _u8(TEXT[:30_000])])
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STENOS_DEVICE_MATCH", "1")
        for name, data in (("tier1", lit), ("tier2", mixed)):
            out.append((name, zstd_frame.encode_frame_device(data, "cpu"),
                        data))
    from stenos_tpu_torch.host import zstd as zstd_host
    for level in (2, 9):
        data = _u8(TEXT[:25_000] + rng.integers(0, 256, 2000,
                                                 np.uint8).tobytes()
                   + TEXT[5000:15_000])
        out.append((f"zstd{level}", zstd_host.compress(data, 1 << 20, level),
                    data))
    return out


@pytest.mark.parametrize("i", range(4))
def test_decode_payload_device(payloads, i):
    name, payload, data = payloads[i]
    before = device_decode.host_ladder
    got = device_decode.decode_payload_device(payload, len(data), "cpu")
    assert device_decode.host_ladder == before
    assert got is not None and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), data), name
    want = ref_decode.decode_payload_device(payload, len(data),
                                            interpret=True)
    assert np.array_equal(np.asarray(want), data), name


def test_decode_payload_device_hands_back_what_it_cannot_decode():
    """A payload that is no zstd frame goes back to the frame layer (None),
    and host_ladder counts it."""
    before = device_decode.host_ladder
    assert device_decode.decode_payload_device(b"\x01" * 40, 40, "cpu") \
        is None
    assert device_decode.host_ladder == before + 1


def test_decode_payload_device_raises_on_a_corrupt_section():
    """A frame whose headers parse but whose last sequences bitstream is
    corrupt raises StenosError (K7's error flag), as host libzstd does,
    instead of moving to the host; so does decompress on the device
    route."""
    data = TEXT[:20_000]
    f = zstandard.ZstdCompressor(level=3).compress(data)
    bad = bytearray(f)
    bad[-3] ^= 0x5A  # the end of the last sequences bitstream
    before = device_decode.host_ladder
    with pytest.raises(frame.StenosError):
        device_decode.decode_payload_device(bytes(bad), len(data), "cpu")
    assert device_decode.host_ladder == before
    good = bytearray(frame.compress(_u8(data), 1, 2, engine=None))
    assert good[8] == 2  # METHOD_ZSTD: the payload is a zstd frame
    good[-3] ^= 0x5A
    with pytest.raises(frame.StenosError):
        frame.decompress(bytes(good), 1, engine=TorchEngine("cpu"))
    with pytest.raises(frame.StenosError):
        frame.decompress(bytes(good), 1, engine=None)


# --------------------------------------------------------- frame layer
@pytest.mark.parametrize("kind", ["text", "sorted_int32"])
def test_frame_compress_entropy_device_matches_jax(kind, monkeypatch):
    """compress(entropy="device") on the port's CPU engine equals the JAX
    package's host path with the device entropy coder; decompress with the
    engine decodes every zstd superblock on the device route, and host
    libzstd reads the frame too. Text at bpp 1 gives METHOD_ZSTD payloads,
    sorted int32 at bpp 4 METHOD_BLOCK_ZSTD residuals: a device frame and
    its sidecar that host libzstd decodes."""
    monkeypatch.setenv("STENOS_DEVICE_MATCH", "1")
    rng = np.random.default_rng(6)
    if kind == "text":
        bpp, method = 1, 2
        data = np.concatenate([rng.integers(0, 64, 100_000).astype(np.uint8),
                               _u8(TEXT[:28_000]), _u8(TEXT[40_000:60_000])])
    else:
        bpp, method = 4, 5
        data = np.sort(rng.integers(0, 1 << 20, 70_000)).astype(
            "<u4").view(np.uint8)
    eng = TorchEngine("cpu")
    got = frame.compress(data, bpp, 2, engine=eng, entropy="device")
    assert got == ref_frame.compress(data, bpp, 2, engine=None,
                                     entropy="device")
    assert got[8] == method
    before = device_decode.host_ladder
    assert np.array_equal(frame.decompress(got, bpp, engine=eng), data)
    assert device_decode.host_ladder == before
    assert np.array_equal(frame.decompress(got, bpp, engine=None), data)
    # without an engine the coder runs on the default device ("cuda"),
    # here on the CPU, as the JAX host path runs it on its default device
    assert frame.compress(data, bpp, 2, engine=None, entropy="device",
                          device="cpu") == got
    with pytest.raises(ValueError):
        frame.compress(data, bpp, 2, engine=eng, entropy="libzstd")


@pytest.mark.parametrize("dm", ["0", "1"])
def test_frame_compress_entropy_device_without_engine(dm, monkeypatch):
    """frame.compress(..., engine=None, entropy="device"): the host block
    path with the device entropy coder (on the CPU here; "cuda" unless
    given), equal to the JAX package's same call under both match routes
    (tests/test_entropy_pallas.py calls it so)."""
    monkeypatch.setenv("STENOS_DEVICE_MATCH", dm)
    rng = np.random.default_rng(9)
    data = np.concatenate([_u8(TEXT[:30_000]),
                           rng.integers(0, 32, 20_000).astype(np.uint8)])
    got = frame.compress(data, 1, 2, engine=None, entropy="device",
                         device="cpu")
    assert got == ref_frame.compress(data, 1, 2, engine=None,
                                     entropy="device")
    assert got != frame.compress(data, 1, 2, engine=None)  # not libzstd's
    assert np.array_equal(frame.decompress(got, 1, engine=None), data)


def test_frame_decompress_libzstd_frame_on_device_route():
    """A libzstd-made frame decodes through the device route, every
    superblock on the card's path (host_ladder unchanged)."""
    data = _u8(TEXT[:40_000])
    f = frame.compress(data, 1, 2, engine=None)
    before = device_decode.host_ladder
    assert np.array_equal(frame.decompress(f, 1, engine=TorchEngine("cpu")),
                          data)
    assert device_decode.host_ladder == before


def test_zstd_modules_import_without_jax():
    """A fresh interpreter (this one imported jax already): the stage's
    modules pull in neither jax nor stenos_tpu."""
    mods = ", ".join(f"stenos_tpu_torch.entropy.{m}" for m in (
        "sidecar", "zstd_parse", "fse", "sequences", "match_device",
        "zstd_frame", "seqdec_kernel", "seq_exec", "device_decode",
        "fse_kernel"))
    code = (f"import sys, {mods}; bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'stenos_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=os.path.join(os.path.dirname(__file__), ".."),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
