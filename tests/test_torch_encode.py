"""The encode kernel's plain torch version (stenos_tpu_torch, CPU) against
the JAX package's XLA pipeline and its Pallas kernel in interpret mode.

Each shape batches the five data kinds as five superblocks, so one JAX
compile covers them. The grid covers bpp {2, 3, 4, 8}, nb {1, 3, 8} and
block levels 1 and 2; interpret-mode Pallas is slow, so it runs on two of
the shapes. Streams are compared up to totals (the padding is not part of
the contract); sizes exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stenos_tpu.engine_jax import encode_superblocks_jit
from stenos_tpu.ops.encode_pallas import encode_slabs_body
from stenos_tpu_torch.ops.encode_kernel import (encode_superblocks,
                                                encode_superblocks_plain)

from conftest import gen_elements

KINDS = ["sorted", "random", "same", "rle", "smallrange"]
GRID = [(2, 1, 2), (3, 3, 1), (4, 8, 2), (8, 3, 1)]  # (bpp, nb, level)


@pytest.fixture(autouse=True)
def _no_timing_knobs(monkeypatch):
    # timing-only knobs of the Pallas kernel that change its output
    monkeypatch.delenv("STENOS_ENC_KMAX", raising=False)
    monkeypatch.delenv("STENOS_ENC_NOPACK", raising=False)


def _batch(rng, bpp, nb):
    sbytes = nb * 256 * bpp
    return np.stack([
        np.frombuffer(gen_elements(rng, bpp, sbytes // bpp + 1, k),
                      np.uint8)[:sbytes] for k in KINDS])


def _plain(batch, bpp, level):
    out = encode_superblocks_plain(torch.from_numpy(batch), bpp, level)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("bpp,nb,level", GRID)
def test_plain_matches_xla_pipeline(rng, bpp, nb, level):
    batch = _batch(rng, bpp, nb)
    streams, totals, bsizes, fsizes = _plain(batch, bpp, level)
    ref = [np.asarray(t) for t in encode_superblocks_jit(batch, bpp, level)]
    assert np.array_equal(totals, ref[1])
    assert np.array_equal(bsizes, ref[2])
    assert np.array_equal(fsizes, ref[3])
    for i, t in enumerate(totals):
        assert streams[i, :t].tobytes() == ref[0][i, :t].tobytes(), KINDS[i]


@pytest.mark.usefixtures("no_persistent_cache")
@pytest.mark.parametrize("bpp,nb,level", [(3, 3, 1), (4, 8, 2)])
def test_plain_matches_pallas_interpret(rng, bpp, nb, level):
    batch = _batch(rng, bpp, nb)
    streams, totals, bsizes, fsizes = _plain(batch, bpp, level)
    rows, tot, bs, fs = (np.asarray(t) for t in encode_slabs_body(
        jnp.asarray(batch), bpp, level, interpret=True))
    assert np.array_equal(bsizes, bs) and np.array_equal(fsizes, fs)
    for i, t in enumerate(totals):
        # the kernel's rows carry the 4-byte record header [1, csize u24]
        assert tot[i] == t + 4
        assert rows[i, 4 : 4 + t].tobytes() == streams[i, :t].tobytes()


def test_wrapper_uses_plain_on_cpu(rng):
    batch = torch.from_numpy(_batch(rng, 4, 1))
    got = encode_superblocks(batch, 4, 2)
    want = encode_superblocks_plain(batch, 4, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
