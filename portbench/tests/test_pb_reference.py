"""The plain reference against frames made by the JAX package's host path
(stenos_tpu, held byte for byte to the C++ stenos library by the repo's
tests), stored under data/: the inputs are made again here from their
seeds."""

import os

import numpy as np
import pytest
import torch

from reference.block_frame import block_frame, frame_header

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _sorted(seed, nbytes):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 1 << 30, nbytes // 4)).astype(
        np.uint32).view(np.uint8)


def _mixed(seed, nbytes):
    rng = np.random.default_rng(seed)
    n = nbytes // 4
    return np.concatenate([np.repeat(rng.integers(0, 255, n // 74 + 1),
                                     37)[: n // 2],
                           rng.integers(1000, 1032, n // 2)]).astype(
        np.uint32).view(np.uint8)


KNOWN = [("sorted_seed5_256k.frame", _sorted, 5, 262144),
         ("mixed_seed6_128k.frame", _mixed, 6, 131072)]


def _frame(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,gen,seed,nbytes", KNOWN)
def test_reference_equals_known_frames(name, gen, seed, nbytes):
    x = torch.from_numpy(gen(seed, nbytes).copy()).view(-1, 131072)
    got = block_frame(x, 4, 1, rows_per_step=1)
    assert bytes(got.numpy()) == _frame(name)


@pytest.mark.parametrize("name,gen,seed,nbytes", KNOWN)
def test_control_differs_from_known_frames(name, gen, seed, nbytes):
    """The compress control (block level 0) is not the frame."""
    x = torch.from_numpy(gen(seed, nbytes).copy()).view(-1, 131072)
    assert bytes(block_frame(x, 4, 1, block_level=0).numpy()) != _frame(name)


def test_frame_header():
    assert frame_header(1 << 29, 4, 1) == b"\0" + (1 << 29).to_bytes(7,
                                                                    "little")
    assert frame_header(1 << 29, 1, 2) == b"\0" + (1 << 29).to_bytes(7,
                                                                    "little")
    with pytest.raises(ValueError):
        block_frame(torch.zeros((2, 65536), dtype=torch.uint8), 4, 1)
