"""The spans and counters of compress_frame_device on 1-D columns
(stenos_tpu_torch/utils/trace.py, on the CPU): "stn.short_superblock" is a
child of "stn.compress_frame_device" where a column ends in a short
superblock and absent where it does not; engine.short_superblocks and
engine.short_superblocks_small count those calls, recorder on or off; off,
the recorder records nothing and opens no profiler range."""

import numpy as np
import pytest
import torch

from stenos_tpu_torch import engine
from stenos_tpu_torch.engine import compress_frame_device
from stenos_tpu_torch.utils import trace

SB = 131072


@pytest.fixture(autouse=True)
def switches_off():
    engine.timing = None
    yield
    engine.timing = None


def _column(nbytes, seed=2):
    """nbytes of float64 samples of a smooth random walk."""
    rng = np.random.default_rng(seed)
    v = 100 + np.cumsum(rng.normal(0, 1e-3, nbytes // 8 + 1))
    return torch.from_numpy(np.frombuffer(v.astype("<f8").tobytes(),
                                          np.uint8)[:nbytes].copy())


# column bytes: calls with a short superblock, of those under 128 bytes
COLUMNS = {"whole": (2 * SB, 0, 0), "partial": (SB + 5000, 1, 0),
           "whole_blocks": (SB + 4096, 1, 0), "small": (SB + 100, 1, 1),
           "small_column": (90, 1, 1), "2d": (2 * SB, 0, 0)}


def _call(name):
    x = _column(COLUMNS[name][0])
    return compress_frame_device(x.view(-1, SB) if name == "2d" else x, 8, 1)


@pytest.mark.parametrize("name", list(COLUMNS))
def test_short_superblock_span_is_a_child(name):
    engine.timing = []
    _call(name)
    recs = trace.records()
    top = [s for s in recs if s.name == "stn.compress_frame_device"]
    short = [s for s in recs if s.name == "stn.short_superblock"]
    assert len(top) == 1 and top[0].parent is None
    assert len(short) == COLUMNS[name][1]
    for s in short:
        assert s.parent == top[0].id and s.call == top[0].id
        assert s.superblocks == 1 and s.events is None  # no card here
    n = COLUMNS[name][0]
    assert top[0].nbytes == n and top[0].superblocks == -(-n // SB)


@pytest.mark.parametrize("traced", [False, True])
def test_counters(traced):
    engine.timing = [] if traced else None
    for name, (_, short, small) in COLUMNS.items():
        before = (engine.short_superblocks, engine.short_superblocks_small)
        _call(name)
        assert (engine.short_superblocks - before[0],
                engine.short_superblocks_small - before[1]) == (short, small)


def test_off_records_nothing_and_opens_no_profiler_range():
    engine.timing = []
    engine.timing = None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in ("partial", "small"):
            _call(name)
    assert not [e.name for e in prof.events() if e.name.startswith("stn.")]
    assert trace.records() == [] and trace.report()["spans"] == {}
    assert trace.span("stn.short_superblock") is trace.span("stn.x")
