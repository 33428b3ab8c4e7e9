"""compress_frames_device (stenos_tpu_torch, the CPU plain path): a batch of
images, a frame each, one a row. Each row is held against the JAX package's
host path (stenos_tpu.compress, numpy, held to the C++ library by
test_frame_parity.py), the port's own host path, compress_frame_device of
the image alone and the benchmark's plain reference (portbench/reference/
frame_batch.py), and decodes to its image; zeros follow each frame to the
row's end. An image that is no whole number of superblocks is refused."""

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
from stenos_tpu_torch.engine import (compress_frame_device,
                                     compress_frames_device)
from stenos_tpu_torch.ops.encode_kernel import frames_stride

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
SB = 131072


@functools.lru_cache(maxsize=None)
def _images(n_frames, nbytes):
    """image-u16 images (the benchmark configuration's own generator, on
    the CPU), (n_frames, nbytes) uint8."""
    sys.path[:0] = [p for p in (BENCH,) if p not in sys.path]
    from harness.spec import load_module

    make = load_module(os.path.join(BENCH, "configs", "image-u16.py"),
                       "image_u16_gen").make
    return np.stack([make(2**31 + 23, i, nbytes, torch.device("cpu")).numpy()
                     for i in range(n_frames)])


def _sorted(n_frames, nbytes):
    v = np.sort(np.random.default_rng(11).integers(
        0, 1 << 30, (n_frames, nbytes // 4)), axis=1).astype("<u4")
    return v.view(np.uint8).reshape(n_frames, nbytes)


# (bpp, images, frames, superblocks a frame)
CASES = {
    "image_one": (2, _images, 1, 1),
    "image_batch": (2, _images, 3, 2),
    "image_pair": (2, _images, 2, 1),
    "sorted_one": (4, _sorted, 1, 2),
    "sorted_batch": (4, _sorted, 3, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_row_is_its_image_frame(case):
    bpp, gen, n_frames, n_sb = CASES[case]
    a = gen(n_frames, n_sb * SB)
    x = torch.from_numpy(a.copy())
    before = engine.frames_batched
    out, lengths = compress_frames_device(x, bpp, 1)
    assert engine.frames_batched - before == n_frames
    assert out.shape == (n_frames, frames_stride(n_sb, SB // (256 * bpp),
                                                 bpp, 8))
    assert out.shape[1] % 16 == 0 and lengths.dtype == torch.int64
    sys.path[:0] = [p for p in (BENCH,) if p not in sys.path]
    from reference.frame_batch import frame_batch

    want, want_len = frame_batch(x, bpp, 1)
    assert torch.equal(out, want) and torch.equal(lengths, want_len)
    for f in range(n_frames):
        n = int(lengths[f])
        got = out[f, :n].numpy().tobytes()
        assert got == ref.compress(a[f], bpp, 1)
        assert got == stt.compress(a[f], bpp, 1, engine=None)
        assert stt.decompress(got, bpp, engine=None).tobytes() \
            == a[f].tobytes()
        assert not out[f, n:].any()
        if f == 0:  # the image alone through compress_frame_device
            one, n1 = compress_frame_device(x[0].view(n_sb, SB), bpp, 1)
            assert int(n1) == n and torch.equal(out[0, : one.numel()], one)
            assert not out[0, one.numel():].any()


@pytest.mark.parametrize("shape,bpp,dtype", [
    ((2, SB + 512), 2, torch.uint8),    # whole blocks, no whole superblock
    ((2, SB // 2), 2, torch.uint8),     # shorter than a superblock
    ((1, 2 * SB + 3), 4, torch.uint8),  # not a whole element either
    ((2, SB), 0, torch.uint8),          # no bytesoftype
    ((0, SB), 2, torch.uint8),          # no frames
    ((SB,), 2, torch.uint8),            # not a batch
    ((2, SB // 2), 2, torch.int16),     # not bytes
])
def test_refuses_what_it_lacks(shape, bpp, dtype):
    with pytest.raises(ValueError):
        compress_frames_device(torch.zeros(shape, dtype=dtype), bpp, 1)
