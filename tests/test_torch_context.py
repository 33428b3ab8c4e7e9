"""The port's Context, generic and private-block APIs, time-limited mode,
threads= and engine="auto" (stenos_tpu_torch, CPU) against the JAX
package's on the same seeded inputs: exact bytes and equal arrays.

The port runs with engine=None (the numpy host path) and with
TorchEngine("cpu") (the kernels' plain versions); the JAX side runs its
host path. Timed output depends on the clock, so timed frames are pinned
only under a budget so large that every decision of the controller is
fixed (the top zstd and estimator levels, block level 2, the largest
rounds the input allows); the wall-clock tests are three: the 300 ms
budget, a warmed engine's overshoot and a timed round trip."""

import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import stenos_tpu as st
import stenos_tpu_torch as stt
from stenos_tpu import context as ref_context
from stenos_tpu import frame as ref_frame
from stenos_tpu_torch import context, frame
from stenos_tpu_torch.engine import TorchEngine
from stenos_tpu_torch.utils import demote

ENGINES = ["host", "cpu"]
AMPLE_NS = 10**15  # ~11.6 days: every controller decision is fixed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this worker while the module runs: the plain
    versions run on small inputs, and the suite's other workers hold the
    cores, where torch's thread pool slows them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(kind):
    return None if kind == "host" else TorchEngine("cpu")


def _sorted(n, seed=3, bpp=4):
    rng = np.random.default_rng(seed)
    hi = 1 << (8 * bpp - 2)
    return np.sort(rng.integers(0, hi, n)).astype(f"<u{bpp}").view(np.uint8)


def _walk(n, seed=7):
    """tests/test_foreach_threads.py's data: a random walk of int32."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 80, n)).astype("<i4").view(np.uint8)


# ------------------------------------------------------------ untimed API
@pytest.mark.parametrize("level,shift", [(1, None), (2, 3), (3, None)])
@pytest.mark.parametrize("eng", ENGINES)
def test_compress_generic_matches_jax(eng, level, shift):
    data = _sorted(150_001)[:-2]  # a partial last element block
    ctx = stt.Context(level=level, blocksize_shift=shift, engine=_engine(eng))
    got = stt.compress_generic(ctx, data, 4)
    want = st.compress_generic(st.Context(level=level, blocksize_shift=shift),
                               data, 4)
    assert got == want
    # level 3 gives transposed zstd superblocks, whose device decode walks
    # the sequences one at a time in the plain versions: host path here
    if level < 3:
        assert np.array_equal(stt.decompress_generic(ctx, got, 4), data)
    else:
        assert np.array_equal(frame.decompress(got, 4, engine=None), data)


@pytest.mark.parametrize("eng", ENGINES)
def test_private_block_api_matches_jax(eng):
    """stenos_private_* parity (stenos.h:294-301): the cvector bucket unit,
    one superblock record, at a full and a partial superblock."""
    data = _sorted(65536 // 4 * 4)[:65536]
    ctx = stt.Context(level=2, engine=_engine(eng))
    jctx = st.Context(level=2)
    for n in (65536, 5000):
        rec = frame.private_compress_block(ctx, data[:n], 4,
                                           stt.super_block_size(4))
        assert rec == ref_frame.private_compress_block(
            jctx, data[:n], 4, st.super_block_size(4))
        assert frame.private_block_size(rec) == len(rec)
        assert frame.private_block_csize(rec) == len(rec)
        out = frame.private_decompress_block(ctx, rec, 4,
                                             stt.super_block_size(4), n)
        assert np.array_equal(np.asarray(out), data[:n])
    assert frame.private_block_csize(b"") == 0
    with pytest.raises(stt.StenosError):
        frame.private_block_size(b"\x01\x02")
    hdr = frame.private_create_compression_header(len(data), 1 << 20)
    assert hdr == ref_frame.private_create_compression_header(len(data),
                                                              1 << 20)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("eng", ENGINES)
def test_threaded_frames_match_jax(eng, level):
    """threads=4: fresh LZ tables a superblock, so the frame is fixed and
    equals the JAX package's threads=4 frame; it decodes exactly."""
    data = _walk(300_000)
    e = _engine(eng)
    got = frame.compress(data, 4, level, engine=e, threads=4)
    assert got == ref_frame.compress(data, 4, level, threads=4)
    # level 3's transposed zstd superblocks: host decode (see above)
    assert np.array_equal(
        frame.decompress(got, 4, engine=e if level < 3 else None), data)
    assert got == stt.compress(data, 4, level, engine=e, threads=4)


@pytest.mark.parametrize("eng", ENGINES)
def test_threaded_single_superblock_matches_serial(eng):
    rng = np.random.default_rng(8)
    data = rng.integers(0, 50, 65536).astype(np.uint8)
    e = _engine(eng)
    f8 = frame.compress(data, 1, 2, engine=e, threads=8)
    assert f8 == frame.compress(data, 1, 2, engine=e)
    assert f8 == ref_frame.compress(data, 1, 2, threads=8)


def test_threaded_pool_does_host_work_only(monkeypatch):
    """With an engine, the encode kernel runs once before the pool (one
    encode_batch) and once on the calling thread for the partial tail:
    no pool thread launches it."""
    import threading

    from stenos_tpu_torch import engine as eng_mod

    main = threading.get_ident()
    calls = []
    real = eng_mod.encode_superblocks

    def spy(x, bpp, block_level):
        calls.append((threading.get_ident(), x.shape[0]))
        return real(x, bpp, block_level)

    monkeypatch.setattr(eng_mod, "encode_superblocks", spy)
    data = _walk(300_000)  # 9 superblocks and a tail
    got = frame.compress(data, 4, 2, engine=TorchEngine("cpu"), threads=4)
    assert got == ref_frame.compress(data, 4, 2, threads=4)
    assert [t for t, _ in calls] == [main, main]
    assert [n for _, n in calls] == [9, 1]


def test_strong_debug_flag(monkeypatch):
    """STENOS_STRONG_DEBUG=1: the frame is the same, every superblock is
    decoded back before it is emitted (a decoder that lies is caught), on
    both engines; without the flag nothing is decoded."""
    data = _sorted(40_000)
    monkeypatch.setenv("STENOS_STRONG_DEBUG", "1")
    want = ref_frame.compress(data, 4, 2)
    for eng in ENGINES:
        assert frame.compress(data, 4, 2, engine=_engine(eng)) == want
    real = frame._block_decode

    def wrong(payload, bpp, dsize):
        r = real(payload, bpp, dsize).copy()
        r[0] ^= 1
        return r

    monkeypatch.setattr(frame, "_block_decode", wrong)
    with pytest.raises(AssertionError, match="STENOS_STRONG_DEBUG"):
        frame.compress(data, 4, 1, engine=None)
    monkeypatch.setenv("STENOS_STRONG_DEBUG", "0")
    assert frame.compress(data, 4, 1, engine=None) == ref_frame.compress(
        data, 4, 1)


def test_decompress_superblock_with_engine():
    """decompress_superblock's engine: a block stream through
    decode_block_stream (full blocks and a partial tail, under one block
    on the host) and a zstd payload on the device route; every method's
    bytes equal the host path's and the JAX package's."""
    e = TorchEngine("cpu")
    rng = np.random.default_rng(4)
    cases = [(_sorted(9000), 4, 1), (_sorted(9000)[:1000], 4, 1),
             (rng.integers(1000, 1032, 5000).astype("<u4").view(np.uint8),
              4, 2), (_walk(20_000), 4, 4),
             (np.tile(rng.integers(0, 256, 64).astype(np.uint8), 64), 1, 2),
             (rng.integers(0, 256, 700).astype(np.uint8), 1, 1)]
    codes = set()
    for data, bpp, level in cases:
        rec = frame.compress_superblock(data, bpp, level, len(data) + 64)
        assert rec == ref_frame.compress_superblock(data, bpp, level,
                                                    len(data) + 64)
        payload = np.frombuffer(rec, np.uint8)[4:]
        codes.add(rec[0])
        for engine in (None, e):
            out = frame.decompress_superblock(rec[0], payload, bpp,
                                              len(data), engine)
            assert np.array_equal(np.asarray(out), data)
    assert codes == {1, 2, 4, 5, 6}, codes
    bad = frame.compress_superblock(_sorted(9000), 4, 1, 36_064)
    with pytest.raises(stt.StenosError):
        frame.decompress_superblock(1, np.frombuffer(bad, np.uint8)[4:40],
                                    4, 36_000, e)


# ------------------------------------------------------------ timed mode
@pytest.mark.parametrize("eng", ENGINES)
def test_timed_frame_matches_jax_under_an_ample_budget(eng):
    """Timed mode with every decision fixed: the port's host loop and its
    engine rounds (1, then 8 superblocks of 128 KiB, a partial tail) give
    the JAX host loop's frame."""
    data = _sorted(300_001)[:-1]
    ctx = stt.Context(max_nanoseconds=AMPLE_NS, engine=_engine(eng))
    got = stt.compress_generic(ctx, data, 4)
    assert got == st.compress_generic(st.Context(max_nanoseconds=AMPLE_NS),
                                      data, 4)
    assert got[0] == 255 and not ctx.t.finish_memcpy
    assert np.array_equal(stt.decompress(got, 4, engine=None), data)


def test_prepare_superblock_and_rounds_match_jax():
    """The timed superblock sizing (power-of-two block counts) and the
    round-sizing controller give the JAX package's sizes."""
    for bpp in (1, 2, 4, 8, 24):
        for nbytes in (1000, 123_456, 1 << 20, 8_000_000, 512 << 20):
            for threads in (1, 4):
                for ns in (0, 5):
                    c = stt.Context(threads=threads, max_nanoseconds=ns,
                                    engine=None)
                    j = st.Context(threads=threads, max_nanoseconds=ns)
                    assert (c.prepare_superblock(bpp, nbytes)
                            == j.prepare_superblock(bpp, nbytes))
    for rates in ([], [1e9], [5e8, 1e9, 2e9], [1e7] * 4):
        for rem_t in (10.0, 1.0, 0.05, 0.0):
            for sb in (131072, 2 << 20):
                assert (frame.next_round_size(rates, rem_t, sb)
                        == ref_frame.next_round_size(rates, rem_t, sb))


def test_round_sizing_controller():
    """tests/test_time_limited.py's bound on the controller: a round takes
    at most 25% of the remaining budget at the slowest recent rate (or one
    superblock), and shrinks as the budget drains."""
    sb = 262144
    histories = [[1e9], [5e8, 1e9, 2e9], [1e9, 1e8, 3e9, 2e9], [1e7] * 4]
    for rates in histories:
        prev = None
        for rem_t in (10.0, 1.0, 0.25, 0.05, 0.01, 0.001, 0.0):
            r = frame.next_round_size(rates, rem_t, sb)
            assert 1 <= r <= 64
            if prev is not None:
                assert r <= prev
            prev = r
            worst = r * sb / min(rates)
            assert worst <= max(0.25 * rem_t, sb / min(rates))
    assert frame.next_round_size([], 10.0, sb) == 1


def test_controller_functions_match_jax():
    """level_for_rate, clevel_for_remaining and find_block_level on a grid
    of progress states (the clock stubbed) equal the JAX package's."""
    for rate in (1e5, 3e6, 8e6, 3e7, 5e7, 1e8, 2.5e8, 4e8, 1e9):
        for shift in (0, 1):
            assert (context.level_for_rate(rate, shift)
                    == ref_context.level_for_rate(rate, shift))
    for el in (0, 10**6, 10**8, 4 * 10**8, 9 * 10**8, 2 * 10**9):
        for done in (0, 10**6, 5 * 10**6, 9 * 10**6):
            for target in (None, 5e6):
                outs = []
                for mod in (context, ref_context):
                    t = mod.TimeConstraint(10**9)
                    t.total_bytes, t.processed_bytes = 10**7, done
                    t.elapsed = lambda el=el: el
                    outs.append((mod.clevel_for_remaining(t, done, target),
                                 mod.find_block_level(t, 0),
                                 t.finish_memcpy))
                assert outs[0] == outs[1], (el, done, target)


@pytest.mark.parametrize("eng", ENGINES)
def test_tiny_budget_degrades_to_memcpy(eng):
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << 31, 500_000).astype("<u4").view(np.uint8)
    ctx = stt.Context(max_nanoseconds=1, engine=_engine(eng))
    f = stt.compress_generic(ctx, data, 4)
    assert np.array_equal(stt.decompress(f, 4, engine=None), data)
    # nearly everything COPY superblocks (the engine's 1-superblock
    # calibration round may compress)
    assert len(f) >= len(data) * 0.9


def test_unsatisfiable_budget_warns():
    """A budget below the measured warm floor warns once at call time and
    marks the controller; the frame still decodes."""
    data = _sorted(200_000)
    ctx = stt.Context(max_nanoseconds=10_000_000_000, engine=None)
    stt.compress_generic(ctx, data, 4)
    assert context.timed_floor_ns("host") is not None
    demote._seen.discard("timed-floor-host")
    ctx = stt.Context(max_nanoseconds=1, engine=None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        f = stt.compress_generic(ctx, data, 4)
    assert ctx.t.unsatisfiable
    assert any(isinstance(x.message, demote.DemotionWarning)
               and "warm floor" in str(x.message) for x in w), \
        [str(x.message) for x in w]
    assert np.array_equal(stt.decompress(f, 4, engine=None), data)
    ctx = stt.Context(max_nanoseconds=30_000_000_000, engine=None)
    stt.compress_generic(ctx, data, 4)
    assert not ctx.t.unsatisfiable


def test_context_api():
    ctx = stt.Context(engine=None)
    ctx.set_level(99)
    assert ctx.level == 9
    ctx.set_threads(0)
    assert ctx.threads == 1
    ctx.set_max_nanoseconds(123)
    assert ctx.t.nanoseconds == 123
    ctx.set_block_size(4)
    assert ctx.blocksize_shift == 4
    with pytest.raises(ValueError):
        ctx.set_block_size(16)
    ctx.reset()
    assert ctx.level == 1 and ctx.t.nanoseconds == 0
    assert ctx.blocksize_shift is None
    data = _sorted(10_000, bpp=2)
    ctx.set_level(3)
    f = stt.compress_generic(ctx, data, 2)
    assert f == frame.compress(data, 2, 3) == st.compress(data, 2, 3)
    ctx.prepare_superblock(2, len(data))
    assert ctx.memory_footprint() == 3 * (ctx.superblock_size + 4)
    t = stt.Timer()
    t.tick()
    assert np.array_equal(stt.decompress_generic(ctx, f, 2), data)
    assert t.tock() > 0
    assert stt.has_error(-6) and not stt.has_error(len(f))
    with pytest.raises(stt.StenosError):
        stt.compress_generic(ctx, data, 0)


# ------------------------------------------------- engines and defaults
def test_entry_points_default_to_the_card():
    """Context() and CompressedArray() take a TorchEngine on "cuda" (none
    here, so they raise); device="cpu" and engine=None as asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.Context()
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.CompressedArray(np.int32)
    assert stt.Context(device="cpu").engine.device.type == "cpu"
    assert stt.Context(engine=None).engine is None
    with pytest.raises(ValueError):
        stt.Context(engine=None, device="cpu")
    assert stt.CompressedArray(np.int32, device="cpu").engine.device.type \
        == "cpu"


def test_engine_auto():
    """engine="auto": the host path below 4 MiB to compress (1 MiB of frame
    to decompress), the same bytes; at and above, the card, which raises
    here rather than falling back."""
    data = _sorted(300_000)
    f = stt.compress(data, 4, 2, engine="auto")
    assert f == frame.compress(data, 4, 2, engine=None)
    assert f == ref_frame.compress(data, 4, 2, engine="auto")
    assert np.array_equal(stt.decompress(f, 4, engine="auto"), data)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the large inputs would run there")
    big = np.zeros(frame.AUTO_COMPRESS_BYTES, np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.compress(big, 4, 1, engine="auto")
    stt.compress(big[:-1], 1, 1, engine="auto")  # below: the host path
    copy = frame.compress(big[: frame.AUTO_DECOMPRESS_BYTES], 1, 0,
                          engine=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.decompress(copy, 1, engine="auto")


def test_failed_launch_raises_not_falls_back(monkeypatch):
    """A kernel that fails in the timed rounds, in warmup or in a container
    chunk raises: no entry point takes the host path instead."""
    from stenos_tpu_torch import engine as eng_mod

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(eng_mod, "encode_superblocks", broken)
    data = _sorted(100_000)
    ctx = stt.Context(max_nanoseconds=AMPLE_NS, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        stt.compress_generic(ctx, data, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        ctx.warmup(4, len(data), max_r=2)
    a = stt.CompressedArray(np.int32, device="cpu", max_raw_buckets=2)
    with pytest.raises(RuntimeError, match="launch failed"):
        a.extend(np.arange(5000, dtype=np.int32))


# --------------------------------------------------- wall-clock (three)
def test_time_limited_roundtrip_and_budget():
    """tests/test_time_limited.py's budget: 2 M int32 under 300 ms on the
    host path, within 1.35x + 250 ms, exact round trip."""
    data = _sorted(2_000_000, seed=12345)
    warm = stt.Context(max_nanoseconds=50_000_000, engine=None)
    stt.compress_generic(warm, data[:800_000], 4)
    budget_ns = 300_000_000
    ctx = stt.Context(max_nanoseconds=budget_ns, engine=None)
    t0 = time.perf_counter_ns()
    f = stt.compress_generic(ctx, data, 4)
    elapsed = time.perf_counter_ns() - t0
    assert np.array_equal(stt.decompress(f, 4, engine=None), data)
    assert elapsed < budget_ns * 1.35 + 250_000_000, elapsed


def test_timed_warmed_engine_overshoot():
    """After Context.warmup (the encode built, the round buffers allocated)
    a TorchEngine("cpu") timed call overshoots by about one round: median
    of 3 under 200 ms, as tests/test_time_limited.py asserts."""
    data = _sorted(1_000_000)
    engine = TorchEngine("cpu")
    warm = stt.Context(max_nanoseconds=1, engine=engine)
    warm.warmup(4, len(data), max_r=8, block_levels=(0, 1, 2))
    budget_ns = 250_000_000
    overs = []
    for _ in range(3):
        ctx = stt.Context(max_nanoseconds=budget_ns, engine=engine)
        t0 = time.perf_counter_ns()
        f = stt.compress_generic(ctx, data, 4)
        overs.append(time.perf_counter_ns() - t0 - budget_ns)
        # host decode: zstd superblocks' device decode walks sequences one
        # at a time in the plain versions
        assert np.array_equal(stt.decompress(f, 4, engine=None), data)
    overs.sort()
    assert overs[1] < 200_000_000, overs


def test_timed_rounds_round_trip():
    """The engine's timed rounds under a generous budget compress and
    decode exactly; under a budget of 2 ns they self-rescue to memcpy."""
    data = _sorted(400_000)
    engine = TorchEngine("cpu")
    ctx = stt.Context(max_nanoseconds=10_000_000_000, engine=engine)
    f = stt.compress_generic(ctx, data, 4)
    assert np.array_equal(stt.decompress(f, 4, engine=None), data)
    assert len(f) < len(data) // 2
    ctx = stt.Context(max_nanoseconds=2, engine=engine)
    f = stt.compress_generic(ctx, data, 4)
    assert np.array_equal(stt.decompress(f, 4, engine=None), data)
    assert len(f) >= len(data) * 0.9


def test_new_modules_import_without_jax():
    """A fresh interpreter: the package and its new modules pull in
    neither jax nor stenos_tpu."""
    code = ("import sys, stenos_tpu_torch, stenos_tpu_torch.context, "
            "stenos_tpu_torch.container, stenos_tpu_torch.utils.timer, "
            "stenos_tpu_torch.utils.demote; bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'stenos_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=os.path.join(os.path.dirname(__file__), ".."),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
