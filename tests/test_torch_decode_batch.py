"""The batched block decode of the port (stenos_tpu_torch, torch engine on
the CPU): frame.decompress gathers full-size METHOD_BLOCK and
METHOD_BLOCK_ZSTD superblocks into batches of one decode-kernel call each,
against the port's host path and the JAX package's; and the decode
kernel's launch plan."""

import numpy as np
import pytest
import torch

from stenos_tpu import frame as ref_frame
from stenos_tpu_torch import engine, frame
from stenos_tpu_torch.constants import (ERROR_INVALID_INPUT, METHOD_BLOCK,
                                        METHOD_BLOCK_ZSTD, METHOD_COPY,
                                        METHOD_ZSTD)
from stenos_tpu_torch.engine import TorchEngine
from stenos_tpu_torch.host import staging
from stenos_tpu_torch.ops.decode_kernel import (OUT_MAX, SMEM_LIMIT,
                                                launch_plan)

from conftest import gen_elements

BPP = 4
SHIFT = 5  # superblocks of 256 * BPP << SHIFT = 32 KiB
KINDS = ("sorted", "smallrange", "random", "sorted", "rle", "same",
         "smallrange")


def _records(f, bpp):
    """[(method, position of the record)] of a frame."""
    _, _, pos = frame.get_info(f, bpp)
    out = []
    while pos < len(f):
        out.append((f[pos], pos))
        pos += 4 + int.from_bytes(f[pos + 1 : pos + 4], "little")
    return out


@pytest.fixture(scope="module")
def mixed():
    """A level-2 frame of 7 full superblocks and a short tail whose methods
    are BLOCK, BLOCK_ZSTD, COPY, BLOCK, ZSTD, BLOCK_ZSTD, BLOCK_ZSTD and
    COPY."""
    rng = np.random.default_rng(11)
    sb = 256 * BPP << SHIFT
    parts = [np.frombuffer(gen_elements(rng, BPP, sb // BPP, k),
                           np.uint8)[:sb] for k in KINDS]
    data = np.concatenate(parts + [parts[0][:100]])
    f = frame.compress(data, BPP, 2, custom_shift=SHIFT)
    assert f == ref_frame.compress(data, BPP, 2, custom_shift=SHIFT)
    return data, f, sb


def test_mixed_frame_decodes_as_the_host_paths(mixed):
    data, f, _ = mixed
    methods = [m for m, _ in _records(f, BPP)]
    assert {METHOD_BLOCK, METHOD_BLOCK_ZSTD} <= set(methods[:-1])
    assert {METHOD_COPY, METHOD_ZSTD} <= set(methods)
    got = frame.decompress(f, BPP, engine=TorchEngine("cpu"))
    assert got.tobytes() == data.tobytes()
    assert frame.decompress(f, BPP, engine=None).tobytes() == data.tobytes()
    assert ref_frame.decompress(f, BPP, engine=None).tobytes() == \
        data.tobytes()


@pytest.mark.parametrize("per_batch", [1, 2, 64])
def test_one_decode_call_per_batch(mixed, monkeypatch, per_batch):
    """The five BLOCK and BLOCK_ZSTD superblocks go to ceil(5 / per_batch)
    calls of the decode kernel's wrapper, each with its batch's rows."""
    data, f, sb = mixed
    calls = []
    real = engine.decode_rows

    def spy(vbufs, *a):
        calls.append(vbufs.shape[0])
        return real(vbufs, *a)

    monkeypatch.setattr(engine, "decode_rows", spy)
    monkeypatch.setattr(engine, "CHUNK_BYTES", per_batch * sb)
    got = frame.decompress(f, BPP, engine=TorchEngine("cpu"))
    assert got.tobytes() == data.tobytes()
    n = sum(m in (METHOD_BLOCK, METHOD_BLOCK_ZSTD)
            for m, _ in _records(f, BPP)[:-1])
    assert n == 5
    assert calls == [min(per_batch, n - i) for i in range(0, n, per_batch)]


@pytest.mark.parametrize("per_batch", [1, 2])
def test_corrupt_residual_in_a_batch_raises_after_the_ones_before(
        mixed, monkeypatch, per_batch):
    """A BLOCK_ZSTD residual whose zstd frame does not decode (alone in its
    batch, or second): the host path's error, after the superblocks before
    it that the batchers hold (BLOCK 0, 1 and 3, ZSTD 4) are written."""
    _, f, sb = mixed
    recs = _records(f, BPP)
    assert [m for m, _ in recs[3:6]] == [METHOD_BLOCK, METHOD_ZSTD,
                                        METHOD_BLOCK_ZSTD]
    bad = bytearray(f)
    bad[recs[5][1] + 4 : recs[5][1] + 8] = b"\0\0\0\0"  # the zstd magic
    bad = bytes(bad)
    with pytest.raises(frame.StenosError) as e:
        frame.decompress(bad, BPP, engine=None)
    assert e.value.code == ERROR_INVALID_INPUT
    written = []
    real = staging.put

    def spy(out, run, host):
        if run is not None:
            written.append((run[0], run[2]))
        return real(out, run, host)

    monkeypatch.setattr(staging, "put", spy)
    monkeypatch.setattr(engine, "CHUNK_BYTES", per_batch * sb)
    with pytest.raises(frame.StenosError) as e:
        frame.decompress(bad, BPP, engine=TorchEngine("cpu"))
    assert e.value.code == ERROR_INVALID_INPUT
    assert sorted(i for w, n in written
                  for i in range(w // sb, (w + n) // sb)) == [0, 1, 3, 4]


def _tiles(plan, bpp, nb):
    """(first plane, planes) in stream order of each tile, as the kernel
    computes them."""
    t = np.arange(plan["tiles"])
    kb, group = plan["tile_blocks"], plan["group"]
    if kb:
        b0 = t * kb
        return b0 * bpp, np.minimum(kb, nb - b0) * bpp
    gpb = -(-bpp // group)
    g0 = t % gpb * group
    return t // gpb * bpp + g0, np.minimum(group, bpp - g0)


def test_launch_plan_fits_and_covers_every_plane():
    """For bpp 1-1024 at the frame's superblock and at 1-512 blocks, one and
    512 superblocks a call: the plan fits a CTA's shared memory, its tiles
    take every plane of a superblock once, in order, a tile's output and
    raw planes fit their buffers, and a tile has whole steps of slots
    planes but for its last (a step takes the tile's next slots planes)."""
    for bpp in range(1, 1025):
        sb_nb = frame.super_block_size(256 * bpp) // (256 * bpp)
        for nb in {sb_nb, 1, 2, 3, 7, 32, 128, 512}:
            for n_sb in (1, 512):
                p = launch_plan(bpp, nb, n_sb)
                assert p["smem"] <= SMEM_LIMIT, (bpp, nb, p)
                assert p["threads"] in (32, 64, 128, 256), (bpp, nb, p)
                assert (p["tile_blocks"] == 0) == (256 * bpp > OUT_MAX)
                p0, n = _tiles(p, bpp, nb)
                assert p0[0] == 0 and (n > 0).all(), (bpp, nb, p)
                assert (p0[1:] == p0[:-1] + n[:-1]).all(), (bpp, nb, p)
                assert p0[-1] + n[-1] == nb * bpp, (bpp, nb, p)
                assert 256 * n.max() <= min(p["out_bytes"], p["stage"])
    # a one-slab read spreads; a 64 MiB call fills the card in waves
    assert launch_plan(4, 128, 1)["tiles"] >= 128
    assert 512 * launch_plan(4, 128, 512)["tiles"] >= 8 * 132


@pytest.fixture(scope="module")
def level1():
    """A level-1 frame of 6 full METHOD_BLOCK superblocks of sorted int32:
    three batches of two."""
    rng = np.random.default_rng(5)
    sb = 256 * BPP << SHIFT
    data = np.sort(rng.integers(0, 1 << 30, 6 * sb // BPP)).astype(
        "<u4").view(np.uint8)
    f = frame.compress(data, BPP, 1, custom_shift=SHIFT)
    assert [m for m, _ in _records(f, BPP)] == [METHOD_BLOCK] * 6
    return data, f, sb


def test_keep_device_takes_the_batcher_with_its_device_sink(level1,
                                                            monkeypatch):
    """decompress_frame_batched(keep_device=True) through frame's batcher:
    one tensor a batch of two superblocks, the two parse buffer sets in
    turns (the first refilled by the third batch), the data in order."""
    data, f, sb = level1
    sets = []
    real = engine.prepare_blocks

    def spy(fr, items, bpp, sb_, bufs):
        sets.append(bufs)
        return real(fr, items, bpp, sb_, bufs)

    monkeypatch.setattr(engine, "prepare_blocks", spy)
    monkeypatch.setattr(engine, "CHUNK_BYTES", 2 * sb)
    got = engine.decompress_frame_batched(f, BPP, device="cpu",
                                          keep_device=True)
    assert [t.numel() for t in got] == [2 * sb] * 3
    assert sets[0] is sets[2] and sets[0] is not sets[1]
    assert torch.cat(got).numpy().tobytes() == data.tobytes()
    assert frame.decompress(f, BPP).tobytes() == data.tobytes()


def test_keep_device_gives_none_for_a_corrupt_third_batch(level1,
                                                          monkeypatch):
    """A superblock of the third batch that the row parse rejects: None,
    and the next call, on the good frame, decodes it right."""
    data, f, sb = level1
    bad = bytearray(f)
    bad[_records(f, BPP)[4][1] + 4] = 0xFF  # its first block header
    monkeypatch.setattr(engine, "CHUNK_BYTES", 2 * sb)
    eng = TorchEngine("cpu")
    assert engine.decompress_frame_batched(bytes(bad), BPP, eng,
                                           keep_device=True) is None
    got = engine.decompress_frame_batched(f, BPP, eng, keep_device=True)
    assert len(got) == 3
    assert torch.cat(got).numpy().tobytes() == data.tobytes()
