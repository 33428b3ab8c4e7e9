"""The port's span recorder (stenos_tpu_torch/utils/trace.py) on the CPU:
off, it records nothing and opens no profiler range; on (engine.timing or
device_decode.timing set), spans nest with their self times, a device
frame compress carries its span and its launch's span into a profiler
trace, a new recording drops the old one; the timing switches keep their
records' shapes, the launch counters do not move with tracing, and
profile_trace writes a trace that names the spans."""

import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from stenos_tpu_torch import engine, frame
from stenos_tpu_torch.engine import TorchEngine, compress_frame_device
from stenos_tpu_torch.entropy import device_decode
from stenos_tpu_torch.utils import trace
from stenos_tpu_torch.utils.timer import profile_trace

SB = 131072
FRAME_SPANS = ("stn.compress_frame_device", "stn.k1.launch")


@pytest.fixture(autouse=True)
def switches_off():
    """Both switches off before and after each test."""
    engine.timing = device_decode.timing = None
    yield
    engine.timing = device_decode.timing = None


def _sorted_tensor(n_sb=2, seed=1):
    a = np.sort(np.random.default_rng(seed).integers(0, 1 << 30,
                                                     n_sb * SB // 4))
    return torch.from_numpy(a.astype("<u4").view(np.uint8).copy()).view(
        n_sb, SB)


def _profiled(fn):
    """The names of the CPU profiler's events while fn runs."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_off_records_nothing_and_opens_no_profiler_range():
    engine.timing = []
    engine.timing = None  # an empty recording
    assert trace.span("stn.x") is trace.span("stn.y")  # the shared null
    x = _sorted_tensor()
    names = _profiled(lambda: compress_frame_device(x, 4, 1))
    assert not [n for n in names if n.startswith("stn.")]
    assert trace.records() == [] and trace.report()["spans"] == {}


@pytest.mark.parametrize("switch", ["engine", "device_decode"])
def test_either_switch_turns_the_recorder_on(switch):
    mod = engine if switch == "engine" else device_decode
    mod.timing = [] if switch == "engine" else {}
    with trace.span("stn.x"):
        pass
    mod.timing = None
    assert [s.name for s in trace.records()] == ["stn.x"]
    with trace.span("stn.after"):
        pass
    assert [s.name for s in trace.records()] == ["stn.x"]


def test_nesting_self_time_and_handed_parents():
    engine.timing = []
    seen = {}
    with trace.span("stn.outer", nbytes=10, superblocks=1) as outer:
        time.sleep(0.01)
        with trace.span("stn.inner", nbytes=5) as inner:
            assert trace.current() is inner
            time.sleep(0.02)
        parent = trace.current()

        def work():
            assert trace.current() is None
            with trace.span("stn.thread", parent=parent) as t:
                seen["thread"] = t
                time.sleep(0.005)

        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    assert trace.current() is None
    t = seen["thread"]
    assert inner.parent == outer.id and inner.call == outer.id
    assert t.parent == outer.id and t.call == outer.id
    assert outer.parent is None and outer.call == outer.id
    r = trace.report()["spans"]
    o, i = r["stn.outer"], r["stn.inner"]
    assert o["calls"] == i["calls"] == 1
    # another thread's child is no part of the outer span's own thread
    assert o["self_ms"] == pytest.approx(o["host_ms"] - i["host_ms"],
                                         abs=1e-6)
    assert i["self_ms"] == pytest.approx(i["host_ms"], abs=1e-9)
    assert i["host_ms"] >= 20 and o["self_ms"] >= 10
    assert o["host_ms"] == o["max_ms"] >= 30
    assert (o["bytes"], o["superblocks"], i["bytes"]) == (10, 1, 5)
    assert o["device_ms"] is None and trace.report()["gaps_ms"] == {}


def test_compress_frame_device_spans_in_a_profiler_trace():
    x = _sorted_tensor()
    engine.timing = []
    names = _profiled(lambda: [compress_frame_device(x, 4, 1)
                               for _ in range(2)])
    assert set(FRAME_SPANS) <= names
    recs = trace.records()
    assert [s.name for s in recs] == list(FRAME_SPANS) * 2
    for k in (0, 2):
        top, k1 = recs[k : k + 2]
        assert top.parent is None and k1.parent == top.id
        assert k1.call == top.id
        assert top.nbytes == x.numel() and top.superblocks == 2
    r = trace.report()["spans"]
    top = r["stn.compress_frame_device"]
    assert top["calls"] == 2 and top["bytes"] == 2 * x.numel()
    assert top["self_ms"] == pytest.approx(
        top["host_ms"] - r["stn.k1.launch"]["host_ms"], abs=1e-6)


def test_a_new_recording_drops_the_old_one():
    engine.timing = []
    with trace.span("stn.old"):
        pass
    device_decode.timing = {}  # on already: the same recording
    engine.timing = device_decode.timing = None
    assert [s.name for s in trace.records()] == ["stn.old"]
    device_decode.timing = {}
    assert trace.records() == []
    with trace.span("stn.new"):
        pass
    assert list(trace.report()["spans"]) == ["stn.new"]


def test_timing_records_keep_their_shapes_on_a_cpu_decompress():
    with open(os.path.join(os.path.dirname(__file__), "..", "benchs", "data",
                           "code_text.txt"), "rb") as f:
        text = f.read(16384)
    data = np.frombuffer(text, np.uint8)
    f_text = frame.compress(data, 1, 2, custom_shift=5)  # 2 ZSTD records
    raw = np.sort(np.random.default_rng(3).integers(0, 1 << 30, 6144)
                  ).astype("<u4").view(np.uint8)
    f_block = frame.compress(raw, 4, 1, custom_shift=3)  # 3 BLOCK records
    engine.timing, device_decode.timing = [], {}
    eng = TorchEngine("cpu")
    assert np.array_equal(frame.decompress(f_text, 1, engine=eng), data)
    assert np.array_equal(frame.decompress(f_block, 4, engine=eng), raw)
    assert list(device_decode.timing) == [
        "host_pass", "h2d", "k5", "k7", "d2h_summaries", "layout", "x1",
        "d2h_output", "frame_out"]
    assert all(isinstance(v, float) and v >= 0
               for v in device_decode.timing.values())
    assert device_decode.timing["k7"] > 0
    (rec,) = engine.timing
    assert list(rec) == ["superblocks", "times"] and rec["superblocks"] == 3
    assert list(rec["times"]) == ["unpack_ms", "parse_ms", "wait_ms",
                                  "out_wait_ms", "out_ms"]
    assert rec["times"]["out_ms"] > 0 and rec["times"]["parse_ms"] > 0
    spans = trace.report()["spans"]
    assert rec["times"]["out_ms"] == spans["stn.out_copy"]["host_ms"]
    assert device_decode.timing["k7"] * 1e3 == pytest.approx(
        spans["stn.zstd.k7"]["host_ms"])
    # the host passes ran on the pool's thread, children of no span here
    assert spans["stn.host_pass"]["calls"] == 2
    assert spans["stn.host_pass"]["superblocks"] == 5


@pytest.mark.parametrize("traced", [False, True])
def test_launch_counters_do_not_move_with_tracing(traced):
    """A payload that the device decode hands to host libzstd counts once
    in device_decode.host_ladder, traced or not; the CPU's plain kernels
    count no launch either way."""
    from stenos_tpu_torch.ops import decode_kernel, encode_kernel

    if traced:
        device_decode.timing = {}
    counts = (encode_kernel.launches, encode_kernel.launches_index,
              decode_kernel.launches, device_decode.host_ladder)
    with warnings.catch_warnings():  # the ladder's first payload warns
        warnings.simplefilter("ignore", RuntimeWarning)
        got = device_decode.decode_payloads_device([b"\x01" * 40], [100],
                                                   "cpu")
    assert got == [None]
    compress_frame_device(_sorted_tensor(1), 4, 1)
    assert (encode_kernel.launches, encode_kernel.launches_index,
            decode_kernel.launches, device_decode.host_ladder) == (
        counts[0], counts[1], counts[2], counts[3] + 1)


def test_profile_trace_writes_the_spans(tmp_path):
    path = str(tmp_path / "trace.json")
    x = _sorted_tensor(1)
    with profile_trace(path):
        assert engine.timing == []
        compress_frame_device(x, 4, 1)
    assert engine.timing is None
    with open(path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert set(FRAME_SPANS) <= names
