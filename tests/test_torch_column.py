"""compress_frame_device on 1-D columns of any length (stenos_tpu_torch, the
CPU plain path) against the JAX package's host path (stenos_tpu.compress,
numpy, held to the C++ library by test_frame_parity.py), the port's own
host path and the benchmark's plain reference (portbench/reference/
column_frame.py). A column that is no whole number of superblocks ends in a
short superblock: its whole blocks, a 0xFE partial segment, or under 128
bytes the small-input route (ZSTD, or COPY where ZSTD does not shrink it).
Every frame decodes to its column."""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, set up by conftest.py)

import stenos_tpu as ref
import stenos_tpu_torch as stt
from stenos_tpu_torch import engine
from stenos_tpu_torch.constants import METHOD_BLOCK as BLOCK
from stenos_tpu_torch.constants import METHOD_COPY as COPY
from stenos_tpu_torch.constants import METHOD_ZSTD as ZSTD
from stenos_tpu_torch.engine import compress_frame_device, frame_header_bytes
from stenos_tpu_torch.ops.encode_kernel import column_slot, record_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
SB = 131072
BLOCK8 = 2048  # a block of 256 float64 samples


@functools.lru_cache(maxsize=1)
def _day():
    """The first 4 superblocks of a ts-f64 column (the benchmark
    configuration's own generator, on the CPU)."""
    sys.path[:0] = [p for p in (BENCH,) if p not in sys.path]
    from harness.spec import load_module

    make = load_module(os.path.join(BENCH, "configs", "ts-f64.py"),
                       "ts_f64_gen").make
    return make(2**31 + 11, 0, 4 * SB, torch.device("cpu")).numpy()


def _ts(n, held=0):
    """n bytes of a ts-f64 day; its last `held` bytes a sample held
    (repeated) from the one before them, as a stuck sensor reads."""
    a = _day()[:n].copy()
    if held:
        a[n - held :] = np.resize(a[n - held - 8 : n - held], held)
    return a


def _sorted(bpp, n, seed=7):
    v = np.sort(np.random.default_rng(seed).integers(
        0, 1 << (8 * bpp - 2), n // bpp + 1)).astype(f"<u{bpp}")
    return np.frombuffer(v.tobytes(), np.uint8)[:n].copy()


def _smooth(bpp, n):
    v = 1000 + 200 * np.sin(np.arange(n // bpp + 1) / 500)
    return np.frombuffer(v.astype(f"<u{bpp}").tobytes(), np.uint8)[:n].copy()


# (bpp, data, the last record's method: BLOCK, or on the small-input route
# ZSTD or COPY; None without a short superblock)
CASES = {
    "no_short": (8, lambda: _ts(2 * SB), None),
    "whole_blocks": (8, lambda: _ts(SB + 3 * BLOCK8), BLOCK),
    "partial": (8, lambda: _ts(SB + 3 * BLOCK8 + 704), BLOCK),
    "partial_no_line": (8, lambda: _ts(SB + BLOCK8 + 56), BLOCK),
    "not_multiple_of_8": (8, lambda: _ts(SB + BLOCK8 + 701), BLOCK),
    "small_copy": (8, lambda: _ts(SB + 100), COPY),
    "small_zstd": (8, lambda: _ts(SB + 120, held=112), ZSTD),
    "shorter_than_a_superblock": (8, lambda: _ts(5000), BLOCK),
    "small_column": (8, lambda: _ts(100), COPY),
    "bpp4_sorted": (4, lambda: _sorted(4, 2 * SB + 1024 * 4 + 37), BLOCK),
    "bpp4_smooth": (4, lambda: _smooth(4, SB + 3 * 1024), BLOCK),
    "bpp2_sorted": (2, lambda: _sorted(2, 3 * SB + 2 * 16 * 12 + 1), BLOCK),
    "bpp2_smooth": (2, lambda: _smooth(2, SB - 5), BLOCK),
}


def _methods(frame, bpp):
    """The method code of each record of a frame, in order."""
    pos = stt.get_info(frame, bpp)[2]
    out = []
    while pos < len(frame):
        out.append(frame[pos])
        pos += 4 + int.from_bytes(frame[pos + 1 : pos + 4], "little")
    assert pos == len(frame)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_column_frame_matches_the_host_paths(case):
    bpp, data, last = CASES[case]
    a = data()
    oracle = ref.compress(a, bpp, 1)
    assert oracle == stt.compress(a, bpp, 1, engine=None)
    short0, small0 = engine.short_superblocks, engine.short_superblocks_small
    frame, length = compress_frame_device(torch.from_numpy(a.copy()), bpp, 1)
    got = frame[: int(length)].numpy().tobytes()
    assert got == oracle
    assert stt.decompress(got, bpp, device="cpu").tobytes() == a.tobytes()
    assert not frame[int(length):].any()
    n_full, r = divmod(len(a), SB)
    methods = _methods(got, bpp)
    assert methods[:n_full] == [BLOCK] * n_full
    assert methods[n_full:] == ([last] if last else [])
    small = last in (ZSTD, COPY)
    assert engine.short_superblocks - short0 == (last is not None)
    assert engine.short_superblocks_small - small0 == small
    hlen = len(frame_header_bytes(len(a), SB, bpp, 1))
    nb = SB // (256 * bpp)
    if small:
        assert frame.numel() == hlen + n_full * record_bound(nb, bpp) + r + 4
    elif last:
        assert frame.numel() == hlen + (n_full + 1) * column_slot(
            nb if n_full else 0, r, bpp)
        sys.path[:0] = [p for p in (BENCH,) if p not in sys.path]
        from reference.column_frame import column_frame

        assert column_frame(torch.from_numpy(a.copy()), bpp, 1).numpy(
        ).tobytes() == got


def test_the_2d_path_is_unchanged():
    """A (n_sb, sb) tensor and the same bytes as a column of whole
    superblocks give one frame, to one capacity."""
    a = _ts(2 * SB)
    f2, l2 = compress_frame_device(torch.from_numpy(a).view(2, SB), 8, 1)
    f1, l1 = compress_frame_device(torch.from_numpy(a), 8, 1)
    assert int(l1) == int(l2) and torch.equal(f1, f2)


def test_refuses_what_it_lacks():
    with pytest.raises(ValueError):
        compress_frame_device(torch.zeros(0, dtype=torch.uint8), 8, 1)
    with pytest.raises(ValueError):
        compress_frame_device(torch.zeros(4096, dtype=torch.int32), 8, 1)
