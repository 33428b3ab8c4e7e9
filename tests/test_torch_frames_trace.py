"""The span and counters of compress_frames_device (stenos_tpu_torch/utils/
trace.py, on the CPU): "stn.compress_frames_device" carries the batch's
bytes, superblocks and frames, is handed the frames' device (so that it
records CUDA events on a card) and has "stn.k1.launch" as its child;
engine.frames_batched counts frames, recorder on or off; the batch's one
K1 launch (ops/encode_kernel._frames, its C call stubbed) is counted in
launches and launches_frames, with the batch's geometry; off, the recorder
records nothing and opens no profiler range."""

import numpy as np
import pytest
import torch

from stenos_tpu_torch import engine
from stenos_tpu_torch.engine import compress_frames_device
from stenos_tpu_torch.ops import encode_kernel
from stenos_tpu_torch.ops.encode_kernel import frames_stride, record_bound
from stenos_tpu_torch.utils import trace

SB = 131072


@pytest.fixture(autouse=True)
def switches_off():
    engine.timing = None
    yield
    engine.timing = None


def _batch(n_frames, n_sb=1, seed=4):
    """n_frames images of n_sb superblocks of smooth uint16 samples."""
    rng = np.random.default_rng(seed)
    v = 1000 + np.cumsum(rng.integers(-3, 4, (n_frames, n_sb * SB // 2)),
                         axis=1)
    return torch.from_numpy(v.astype("<u2").view(np.uint8).copy())


@pytest.mark.parametrize("n_frames,n_sb", [(1, 1), (3, 2)])
def test_span_carries_the_batch_and_k1_is_its_child(n_frames, n_sb):
    engine.timing = []
    x = _batch(n_frames, n_sb)
    compress_frames_device(x, 2, 1)
    recs = trace.records()
    top = [s for s in recs if s.name == "stn.compress_frames_device"]
    k1 = [s for s in recs if s.name == "stn.k1.launch"]
    assert len(top) == 1 and top[0].parent is None and len(k1) == 1
    assert k1[0].parent == top[0].id and k1[0].call == top[0].id
    assert (top[0].nbytes, top[0].superblocks, top[0].frames) == (
        x.numel(), n_frames * n_sb, n_frames)
    assert top[0]._device == x.device  # events on a card's stream
    assert top[0].events is None  # none on the CPU
    s = trace.report()["spans"]["stn.compress_frames_device"]
    assert (s["calls"], s["frames"], s["superblocks"]) == (
        1, n_frames, n_frames * n_sb)
    assert s["device_ms"] is None and s["host_ms"] > 0


@pytest.mark.parametrize("traced", [False, True])
def test_frames_batched_counts_frames(traced):
    engine.timing = [] if traced else None
    before = engine.frames_batched
    for n in (1, 3, 2):
        compress_frames_device(_batch(n), 2, 1)
    assert engine.frames_batched - before == 6


def test_one_launch_a_batch(monkeypatch):
    """_frames makes one K1 launch of the batch instantiation a call, for
    every frame of the batch: the grid over all superblocks, a staging row
    of a record bound each, each frame's capacity, its row's stride and its
    superblocks; counted in launches and launches_frames (not in
    launches_frame_placed)."""
    got = []
    monkeypatch.setattr(encode_kernel, "_launch",
                        lambda *a, **kw: got.append((a, kw)))
    counts = ("launches", "launches_frames", "launches_frame_placed")
    before = [getattr(encode_kernel, c) for c in counts]
    hdr = bytes(8)
    nb = SB // 512
    for calls, (n_frames, per) in enumerate([(32, 64), (1, 1), (3, 2)], 1):
        x = torch.empty((n_frames * per, SB), dtype=torch.uint8)
        out, lengths = encode_kernel._frames(x, 2, 2, hdr, n_frames)
        stride = frames_stride(per, nb, 2, 8)
        assert stride == -(-(8 + per * record_bound(nb, 2)) // 16) * 16
        assert out.shape == (n_frames, stride) and lengths.shape == (
            n_frames,)
        a, kw = got[-1]
        # (data, kind, bpp, block level, superblocks, nb, nb_last, row_w,
        # rec, 4 staging addresses, plane_off, frame, cap, header, length,
        # status, per, stride)
        assert a[1:9] == (encode_kernel._FRAMES, 2, 2, n_frames * per, nb,
                          nb, record_bound(nb, 2), 4)
        assert a[13:18] == (0, out.data_ptr(), 8 + per * record_bound(nb, 2),
                            hdr, lengths.data_ptr())
        assert a[19:] == (per, stride) and not kw
        assert len(got) == calls
        assert [getattr(encode_kernel, c) - b
                for c, b in zip(counts, before)] == [calls, calls, 0]


def test_off_records_nothing_and_opens_no_profiler_range():
    engine.timing = []
    engine.timing = None
    x = _batch(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        compress_frames_device(x, 2, 1)
    assert not [e.name for e in prof.events() if e.name.startswith("stn.")]
    assert trace.records() == [] and trace.report()["spans"] == {}
    assert trace.span("stn.compress_frames_device", x.device, frames=2) \
        is trace.span("stn.x")
