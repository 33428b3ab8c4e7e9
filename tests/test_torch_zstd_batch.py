"""The port's batched zstd decode (stenos_tpu_torch, CPU): one
decode_payloads_device call over several payloads against the JAX
package's decode_payload_device on each; the host ladder and corrupt
payloads in a batch; K7's plain version on lanes of several sections (the
repeat offsets resolved on the walk, the section summaries); X1's plain
version on a batch of lanes against the JAX package's programs; and the
frame layer, which gathers a frame's zstd superblocks into such batches,
against the host path, errors included.

The plain sequence walks step once a sequence, so the inputs are small (a
few thousand sequences in all)."""

import os

import numpy as np
import pytest
import torch
import zstandard

from stenos_tpu.entropy import device_decode as ref_decode
from stenos_tpu.entropy import huff_decode_pallas
from stenos_tpu.entropy import seq_exec as ref_exec
from stenos_tpu.native import lib as ref_lib
from stenos_tpu_torch import frame, native
from stenos_tpu_torch.constants import (ERROR_INVALID_INPUT,
                                        ERROR_SRC_OVERFLOW, METHOD_BLOCK,
                                        METHOD_TRANSPOSED_DELTA_ZSTD,
                                        METHOD_TRANSPOSED_ZSTD, METHOD_ZSTD)
from stenos_tpu_torch.engine import TorchEngine
from stenos_tpu_torch.entropy import (device_decode, seq_exec,
                                      seqdec_kernel, zstd_frame)
from stenos_tpu_torch.entropy.huff_decode_kernel import decode_tables
from stenos_tpu_torch.entropy.huff_kernel import WOUT_WORDS
from stenos_tpu_torch.entropy.sequences import encode_sequences
from stenos_tpu_torch.entropy.zstd_parse import parse_frame
from stenos_tpu_torch.host import zstd as zstd_host
from stenos_tpu_torch.ops.delta import delta_np
from stenos_tpu_torch.ops.shuffle import shuffle_np

BLOCK = 131072
JAX_ROW_BYTES = 32768  # the JAX decode's stream rows, padded (jax_decoded)
TEXT = open(os.path.join(os.path.dirname(__file__), "..", "benchs", "data",
                         "code_text.txt"), "rb").read()
lib = native.load()


def _u8(b):
    return np.frombuffer(bytes(b), np.uint8)


def _sections(frame_bytes):
    """The non-empty sequences sections of a zstd frame, in block order."""
    _, blocks, _ = parse_frame(frame_bytes, len(frame_bytes))
    return [frame_bytes[s.seq_off : s.seq_off + s.seq_len] for s in blocks
            if s.btype == 2 and s.seq_len and frame_bytes[s.seq_off] != 0]


@pytest.fixture(scope="module")
def payloads():
    """test_torch_zstd.py's four decode payloads: an all-literals device
    frame (tier 1), a device frame with sequences and anchors in its
    sidecar (tier 2), libzstd frames at stenos levels 2 and 9."""
    rng = np.random.default_rng(5)
    lit = rng.integers(0, 64, BLOCK).astype(np.uint8)
    mixed = np.concatenate([lit, _u8(TEXT[:30_000])])
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STENOS_DEVICE_MATCH", "1")
        for name, data in (("tier1", lit), ("tier2", mixed)):
            out.append((name, zstd_frame.encode_frame_device(data, "cpu"),
                        data))
    for level in (2, 9):
        data = _u8(TEXT[:25_000] + rng.integers(0, 256, 2000,
                                                 np.uint8).tobytes()
                   + TEXT[5000:15_000])
        out.append((f"zstd{level}", zstd_host.compress(data, 1 << 20, level),
                    data))
    return out


@pytest.fixture(scope="module")
def batch(payloads):
    """The four payloads through one decode_payloads_device call, and the
    launches it would make on the card (the CPU wrappers count none)."""
    before = device_decode.host_ladder
    got = device_decode.decode_payloads_device(
        [p for _, p, _ in payloads], [len(d) for _, _, d in payloads], "cpu")
    assert device_decode.host_ladder == before
    return got


@pytest.fixture(scope="module")
def jax_decoded(payloads):
    """stenos_tpu's decode_payload_device(interpret=True) of each payload,
    its Huffman stream rows zero-padded to one width, 32 KiB (stenos_tpu
    pads them to the longest stream, rounded to 128 B), so that the
    interpret-mode Pallas decode is traced and lowered once for the four
    payloads, not once per width."""
    real = huff_decode_pallas.decode_streams_device

    def padded(stream_bytes, anchors, tables, interpret=False, v=None):
        import jax.numpy as jnp

        pad = JAX_ROW_BYTES - stream_bytes.shape[1]
        assert pad >= 0
        stream_bytes = jnp.concatenate(
            [stream_bytes, jnp.zeros((stream_bytes.shape[0], pad),
                                     stream_bytes.dtype)], axis=1)
        return real(stream_bytes, anchors, tables, interpret, v)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(huff_decode_pallas, "decode_streams_device", padded)
        return [np.asarray(ref_decode.decode_payload_device(
            p, len(d), interpret=True)) for _, p, d in payloads]


@pytest.mark.parametrize("i", range(4))
def test_decode_payloads_device_matches_jax(payloads, batch, jax_decoded,
                                            i):
    name, _, data = payloads[i]
    got = batch[i]
    assert got is not None and got.dtype == torch.uint8, name
    assert np.array_equal(got.numpy(), data), name
    assert np.array_equal(jax_decoded[i], got.numpy()), name


def test_native_host_pass_k5_tables_equal_decode_tables(payloads):
    """The native host pass builds K5's decode tables of each job's code
    lengths, one row a stream, as huff_decode_kernel.decode_tables does."""
    lens = [len(p) for _, p, _ in payloads]
    buf = np.frombuffer(b"".join(p for _, p, _ in payloads) + b"\0" * 4,
                        np.uint8)
    status, blocks, rows, anch, jlens, tables, *_ = lib.zstd_prep_batch(
        buf, np.cumsum([0] + lens[:-1]), lens,
        [len(d) for _, _, d in payloads], 2, 4 * WOUT_WORDS)
    assert not status.any() and len(jlens) >= 4
    assert np.array_equal(tables, np.repeat(decode_tables(jlens), 4, axis=0))


def test_batch_hands_back_the_unparseable_and_raises_on_the_corrupt(
        payloads):
    """In a batch, a payload that is no zstd frame comes back None and
    host_ladder counts it, while the others decode; a payload whose last
    sequences bitstream is corrupt makes the whole call raise."""
    _, p1, d1 = payloads[0]
    d2 = _u8(TEXT[:4000])
    p2 = zstd_host.compress(d2.tobytes(), 1 << 20, 3)
    before = device_decode.host_ladder
    got = device_decode.decode_payloads_device([p1, b"\x01" * 40, p2],
                                               [len(d1), 40, len(d2)], "cpu")
    assert device_decode.host_ladder == before + 1
    assert got[1] is None
    assert np.array_equal(got[0].numpy(), d1)
    assert np.array_equal(got[2].numpy(), d2)
    bad = bytearray(p2)
    bad[-3] ^= 0x5A
    with pytest.raises(frame.StenosError) as e:
        device_decode.decode_payloads_device([p1, bytes(bad)],
                                             [len(d1), len(d2)], "cpu")
    assert e.value.code == ERROR_INVALID_INPUT
    assert device_decode.host_ladder == before + 1


# ------------------------------------------------------- K7 on lanes
def test_seq_decode_plain_lanes_resolve_reps_and_summaries():
    """Two lanes of several sections each (libzstd frames at levels 7 and
    3 whose repeat offsets chain across their blocks):
    the raw triples equal stn_zstd_seqs_raw, the offsets the native
    resolve_reps of them (registers from [1, 4, 8] a lane), the summaries
    numpy sums and minima of them."""
    rng = np.random.default_rng(7)
    piece = b"abcdefgh" * 5000 + rng.integers(0, 16, 40_000,
                                              np.uint8).tobytes()
    other = TEXT[:2000] * 20 + rng.integers(0, 16, 50_000,
                                            np.uint8).tobytes()
    frames = [zstandard.ZstdCompressor(level=7).compress(piece * 4),
              zstandard.ZstdCompressor(level=3).compress(other * 3)]
    lanes = [_sections(f) for f in frames]
    assert all(len(secs) >= 2 for secs in lanes)
    preps = []
    for secs in lanes:
        ctx = lib.zstd_ctx()
        preps += [seqdec_kernel.prep_section(s, ctx) for s in secs]
    ll, ml, ofv, off, summ = seqdec_kernel.decode_sections(
        *seqdec_kernel.pack_sections(preps, "cpu", [len(s) for s in lanes]))
    assert seqdec_kernel.launches == 0
    k = s0 = 0
    for secs in lanes:
        ctx = ref_lib.zstd_ctx()
        reps = np.array([1, 4, 8], np.int64)
        for sec in secs:
            n = preps[k]["nseq"]
            sl = slice(s0, s0 + n)
            want = ref_lib.zstd_seqs_raw(sec, ctx)
            for a, b in zip((ll[sl], ml[sl], ofv[sl]), want):
                assert (a.numpy() == b).all()
            o = lib.resolve_reps(want[0], want[2], reps)
            assert (off[sl].numpy() == o).all()
            a_ll, a_ml = (w.astype(np.int64) for w in want[:2])
            src = np.cumsum(a_ll + a_ml) - a_ml - o
            assert summ[k].tolist() == [a_ll.sum(), a_ml.sum(), src.min(), 0]
            s0 += n
            k += 1


def test_seq_decode_plain_flags_a_bad_repeat_offset():
    """A section encoded from other registers than [1, 4, 8] whose first
    sequence is repeat code 3 with no literals (offset = register 1 - 1):
    from [1, 4, 8] that offset is 0, which native resolve_reps rejects and
    K7 flags with error bit 4."""
    seqs = [(0, 1 + 3, 5), (4, 700 + 3, 9)]
    sec = encode_sequences(seqs, reps=(2, 4, 8))
    p = seqdec_kernel.prep_section(sec, lib.zstd_ctx())
    ll, ml, ofv, off, summ = seqdec_kernel.decode_sections(
        *seqdec_kernel.pack_sections([p], "cpu"))
    assert ofv.tolist()[0] == 3 and ll.tolist()[0] == 0
    assert isinstance(lib.resolve_reps(ll.numpy(), ofv.numpy(),
                                       np.array([1, 4, 8], np.int64)), int)
    assert off.tolist()[0] == 0
    assert int(summ[0, 3]) == seqdec_kernel.ERR_REPEAT


# ------------------------------------------------------- X1 on lanes
def _programs_reference(out, lits, ll, ml, off, blocks, lanes):
    """The JAX package's executor (native seq_ops, pack_programs,
    run_programs_numpy) lane by lane: each lane one program over a flat
    [lits | out] buffer; the lane's blocks taken from its run."""
    W = ref_decode.W
    out, lits = out.numpy().copy(), lits.numpy()
    ll, ml, off, blocks = (t.numpy() for t in (ll, ml, off, blocks))
    base = len(lits)
    for b0, b1, _ in lanes.numpy():
        ops = []
        for o_off, o_len, l_off, l_len, s_off, n, _ in blocks[b0:b1]:
            sl = slice(s_off, s_off + n)
            ops.append(ref_lib.seq_ops(
                ll[sl], ml[sl], off[sl].astype(np.int64), base + o_off,
                l_off, l_len - int(ll[sl].sum()), base + o_off + o_len,
                W)[:, :2])
        dst, src, total = ref_exec.pack_programs([np.concatenate(ops)],
                                                 base + len(out), W)
        stage = np.zeros(total, np.uint8)
        stage[:base] = lits
        buf = ref_exec.run_programs_numpy(stage, dst, src, W)
        for o_off, o_len, *_ in blocks[b0:b1]:
            out[o_off : o_off + o_len] = buf[base + o_off : base + o_off
                                             + o_len]
    return out


def test_seq_exec_plain_lanes_match_programs(monkeypatch):
    """X1's call of one batch: a device frame of records and text (one
    staged lane a block, literals from K5's rows) and a libzstd level-9
    frame whose matches cross its blocks (one lane in device memory, host
    literals). Its plain version equals the JAX package's programs and
    gives both inputs back."""
    rng = np.random.default_rng(4)
    rec = np.tile(rng.integers(0, 256, 64).astype(np.uint8), BLOCK // 64)
    d1 = np.concatenate([rec, _u8(TEXT[:9000])])
    piece = rng.integers(0, 256, 90_000, np.uint8).tobytes()
    d2 = _u8(piece * 3 + TEXT[:3000])
    with monkeypatch.context() as mp:
        mp.setenv("STENOS_DEVICE_MATCH", "1")
        p1 = zstd_frame.encode_frame_device(d1, device="cpu")
    p2 = zstandard.ZstdCompressor(level=9).compress(d2.tobytes())
    calls = []
    real = seq_exec.execute

    def spy(out, *rest):
        calls.append((out.clone(), *rest))
        return real(out, *rest)

    monkeypatch.setattr(device_decode, "execute", spy)
    got = device_decode.decode_payloads_device([p1, p2], [len(d1), len(d2)],
                                               "cpu")
    assert np.array_equal(got[0].numpy(), d1)
    assert np.array_equal(got[1].numpy(), d2)
    (out, lits, rows, ll, ml, off, blocks, lanes), = calls
    staged = lanes[:, 2].numpy()
    assert staged.any() and not staged.all() and (blocks[:, 6] >= 0).any()
    plain = seq_exec.execute_plain(out.clone(), lits, rows, ll, ml, off,
                                   blocks, lanes)
    assert np.array_equal(plain.numpy(), np.concatenate([d1, d2]))
    flat, fblocks = seq_exec.gather_literals(lits, rows, blocks)
    want = _programs_reference(out, flat, ll, ml, off, fblocks, lanes)
    assert np.array_equal(plain.numpy(), want)


# ------------------------------------------------------- frame layer
@pytest.fixture(scope="module")
def mixed_frame():
    """(data, frame, record sizes) of 4-byte elements in 8 KiB superblocks
    (a custom superblock size keeps the plain walks short) that are, in
    order, METHOD_BLOCK, METHOD_ZSTD (libzstd), TRANSPOSED_ZSTD,
    TRANSPOSED_DELTA_ZSTD and a partial METHOD_ZSTD (the device encoder,
    with its sidecar), assembled from each method's own encoder."""
    bpp = 4
    sb = 8192
    rng = np.random.default_rng(12)
    sorted_ = np.sort(rng.integers(0, 1 << 20, sb // 4)).astype("<u4")
    text = _u8((TEXT * 2)[: sb])
    ramp = (np.arange(sb // 4) * 3 + 7).astype("<u4")
    parts = [(METHOD_BLOCK, sorted_.view(np.uint8)),
             (METHOD_ZSTD, text),
             (METHOD_TRANSPOSED_ZSTD, np.tile(text[:1024], sb // 1024)),
             (METHOD_TRANSPOSED_DELTA_ZSTD, ramp.view(np.uint8)),
             (METHOD_ZSTD, _u8(TEXT[50_000:55_000]))]
    data = np.concatenate([d for _, d in parts])
    out = [bytes([255]) + len(data).to_bytes(7, "little")
           + sb.to_bytes(4, "little")]
    for i, (method, chunk) in enumerate(parts):
        if method == METHOD_BLOCK:
            rec = frame.compress_superblock(chunk, bpp, 1, 1 << 24)
            assert rec[0] == METHOD_BLOCK
            out.append(rec)
            continue
        src = chunk
        if method != METHOD_ZSTD:
            src = shuffle_np(chunk, bpp)
            if method == METHOD_TRANSPOSED_DELTA_ZSTD:
                src = delta_np(src)
        if i == len(parts) - 1:
            payload = zstd_frame.encode_frame_device(src, device="cpu")
        else:
            payload = zstd_host.compress(src.tobytes(), 1 << 24, 3)
        out.append(bytes([method]) + len(payload).to_bytes(3, "little")
                   + payload)
    return data, b"".join(out), [len(b) for b in out]


def _error_code(fn):
    try:
        fn()
    except frame.StenosError as e:
        return e.code
    return None


def test_frame_decompress_mixed_methods_in_one_batch(mixed_frame):
    """The frame layer sends the four zstd superblocks to one batch of the
    device decode (one host pass, one decode_prepared; the METHOD_BLOCK one
    decodes on its own) and gives the input back, as the host path does."""
    data, f, _ = mixed_frame
    calls = []
    real = device_decode.decode_prepared

    def spy(buf, dsizes, *a, **kw):
        calls.append(len(dsizes))
        return real(buf, dsizes, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_decode, "decode_prepared", spy)
        got = frame.decompress(f, 4, engine=TorchEngine("cpu"))
    assert calls == [4]
    assert np.array_equal(got, data)
    assert np.array_equal(frame.decompress(f, 4, engine=None), data)


@pytest.mark.parametrize("case", ["corrupt", "cut", "corrupt_then_cut"])
def test_frame_decompress_errors_match_host_path(mixed_frame, case):
    """A corrupt zstd payload (its last sequences bitstream), a frame cut
    inside a later superblock header, and both: the engine route raises the
    host path's error, the earlier superblock's first."""
    _, f, sizes = mixed_frame
    ends = np.cumsum(sizes)
    f = bytearray(f)
    if case != "cut":
        f[ends[2] - 3] ^= 0x5A  # superblock 1, METHOD_ZSTD
    if case != "corrupt":
        f = f[: ends[3] + 2]  # inside superblock 3's header
    want = {"corrupt": ERROR_INVALID_INPUT, "cut": ERROR_SRC_OVERFLOW,
            "corrupt_then_cut": ERROR_INVALID_INPUT}[case]
    f = bytes(f)
    assert _error_code(lambda: frame.decompress(f, 4, engine=None)) == want
    assert _error_code(lambda: frame.decompress(
        f, 4, engine=TorchEngine("cpu"))) == want
