"""The encode kernel's plain torch version (stenos_tpu_torch, CPU) against
the JAX package's XLA pipeline and its Pallas kernel in interpret mode.

Each shape batches the five data kinds as five superblocks, so one JAX
compile covers them. The grid covers bpp {1, 2, 3, 4, 8, 24}, nb {1, 2,
3, 8} and block levels 0, 1 and 2 (bpp 1 and 24 are where the CUDA
kernel's tiling changes: 16 blocks a step, and 16-plane steps that end
ragged); interpret-mode Pallas is slow, so it runs on two of the shapes.
The kernel's launch plan is checked for bpp 1-1024, and so are the launch
descriptors that cache it (through a prepare step that needs no card), with
the frame mode's scratch layout. Streams are compared up to totals (the
padding is not part of the contract); sizes exactly."""

import ctypes
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stenos_tpu.engine_jax import encode_superblocks_jit
from stenos_tpu.ops.encode_pallas import encode_slabs_body
from stenos_tpu_torch import frame as fr
from stenos_tpu_torch.ops import _cuda, encode_kernel
from stenos_tpu_torch.ops.encode_kernel import (SCRATCH_ALIGN, SMEM_LIMIT,
                                                STAGE_MAX, _SIGNATURES,
                                                column_slot,
                                                encode_superblocks,
                                                encode_superblocks_plain,
                                                launch_plan, record_bound,
                                                scratch_layout)

from conftest import gen_elements

KINDS = ["sorted", "random", "same", "rle", "smallrange"]
GRID = [(2, 1, 2), (3, 3, 1), (4, 8, 2), (8, 3, 1), (1, 1, 0),
        (24, 2, 2)]  # (bpp, nb, level)


@pytest.fixture(autouse=True)
def _no_timing_knobs(monkeypatch):
    # timing-only knobs of the Pallas kernel that change its output
    monkeypatch.delenv("STENOS_ENC_KMAX", raising=False)
    monkeypatch.delenv("STENOS_ENC_NOPACK", raising=False)


def _wide_elements(rng, bpp, nelem, kind):
    """gen_elements' values as zero-extended little-endian bpp-byte
    elements (gen_elements cuts elements wider than 16 bytes short)."""
    a = np.frombuffer(gen_elements(rng, 8, nelem, kind), "<u8")
    out = np.zeros((nelem, bpp), np.uint8)
    out[:, :8] = a.view(np.uint8).reshape(nelem, 8)
    return out.tobytes()


def _batch(rng, bpp, nb):
    sbytes = nb * 256 * bpp
    gen = gen_elements if bpp <= 16 else _wide_elements
    return np.stack([
        np.frombuffer(gen(rng, bpp, sbytes // bpp + 1, k),
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


def _plan_nbs(bpp):
    """The block counts the launch plan is checked at: the frame's
    superblock, one block and 1000 blocks."""
    return {fr.super_block_size(256 * bpp) // (256 * bpp), 1, 1000}


def test_launch_plan_fits_and_covers_every_block():
    """For bpp 1-1024 at the frame's superblock, one block and 1000 blocks:
    the plan fits a CTA's shared memory, its tiles take every block once
    and each stage holds its tile (blocks wider than STAGE_MAX go by plane
    groups), and the output window holds a tile's largest output."""
    for bpp in range(1, 1025):
        hdr_w = (bpp + 1) // 2
        for nb in _plan_nbs(bpp):
            p = launch_plan(bpp, nb)
            assert p["smem"] <= SMEM_LIMIT, (bpp, nb, p)
            kb = p["tile_blocks"]
            assert (kb == 0) == (256 * bpp > STAGE_MAX), (bpp, nb, p)
            if kb:
                starts = range(0, nb, kb)
                covered = [b for b0 in starts
                           for b in range(b0, min(nb, b0 + kb))]
                assert covered == list(range(nb)) and kb <= min(nb, 64)
                assert p["stage_bytes"] >= kb * 256 * bpp
                assert p["win_off"] >= 2 * p["stage_bytes"]
                out = kb * (hdr_w + 256 * bpp)
            else:
                assert p["stage_bytes"] >= 256 * 16
                assert p["win_off"] >= p["stage_bytes"]
                out = 16 * 256
            assert p["codes_off"] - p["win_off"] >= 15 + out, (bpp, nb, p)
            assert p["smem"] - p["codes_off"] >= (kb or 1) * bpp


# C parameter types of csrc/encode_blocks.cu's entries -> ctypes argtypes
_C_TYPES = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int, "unsigned long long": ctypes.c_ulonglong}


@pytest.mark.parametrize("fn", ["stenos_encode_superblocks",
                                "stenos_encode_prepare",
                                "stenos_place_records",
                                "stenos_encode_short"])
def test_signatures_match_the_source(fn):
    """The ctypes argtypes of each entry have the count and order of the
    parameters its C definition declares (a mismatch would pass arguments
    in the wrong registers, unseen without the card)."""
    with open(os.path.join(_cuda.CSRC, "encode_blocks.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert m, fn
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    types = [re.sub(r"\s*\w+$", "", p).replace("const ", "")
             for p in params]
    assert [_C_TYPES[t] for t in types] == _SIGNATURES[fn]


@pytest.fixture
def descriptors(monkeypatch):
    """An empty descriptor cache whose prepare step runs without CUDA (it
    fills in the lag an H100 gives: 132 SMs x 4 CTAs, after
    prepare.delay seconds); yields the list of (device, kind) it was
    called with."""
    calls = []

    def prepare(desc, idx):
        time.sleep(prepare.delay)
        calls.append((idx, desc.kind))
        desc.lag = 528

    prepare.delay = 0

    monkeypatch.setattr(encode_kernel, "_prepare", prepare)
    monkeypatch.setattr(encode_kernel, "_descriptors", {})
    monkeypatch.setattr(encode_kernel, "descriptor_builds", 0)
    yield calls


def test_descriptor_holds_the_launch_plan(descriptors):
    """A cached descriptor's geometry is launch_plan's, computed afresh,
    over the grid test_launch_plan_fits_and_covers_every_block walks, for
    each instantiation; the prepared lag is kept."""
    fields = ("tile_blocks", "pad", "stage_bytes", "win_off", "codes_off",
              "smem")
    for bpp in range(1, 1025):
        for nb in _plan_nbs(bpp):
            plan = launch_plan(bpp, nb)
            for kind in (0, 1, 2, 3):
                desc, addr = encode_kernel._descriptor(0, kind, bpp, nb)
                assert addr == ctypes.addressof(desc)
                assert desc.kind == kind and desc.lag == 528
                assert {f: getattr(desc, f) for f in fields} == {
                    f: plan[f] for f in fields}, (bpp, nb, kind)


def test_descriptor_builds_count_new_keys(descriptors):
    """descriptor_builds counts one build a new (device, instantiation,
    bpp, nb) and none for a key seen before; threads that miss one key
    together build it once and share it."""
    keys = [(0, 1, 4, 128), (0, 2, 8, 64), (0, 1, 8, 64), (0, 0, 4, 128),
            (1, 1, 4, 128), (0, 1, 4, 64)]
    got = {k: encode_kernel._descriptor(*k) for k in keys}
    assert encode_kernel.descriptor_builds == len(keys)
    assert descriptors == [(k[0], k[1]) for k in keys]
    for _ in range(3):  # a steady loop: every call a hit
        for k in keys:
            assert encode_kernel._descriptor(*k) is got[k]
    assert encode_kernel.descriptor_builds == len(keys)

    encode_kernel._prepare.delay = 0.05  # misses meet inside the build
    key, out = (0, 2, 16, 32), []
    n = (os.cpu_count() or 1) + 4
    threads = [threading.Thread(
        target=lambda: out.append(encode_kernel._descriptor(*key)))
        for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(out) == n and all(d is out[0] for d in out)
    assert encode_kernel.descriptor_builds == len(keys) + 1


def _column_slot_rows(r, bpp=8, sb=131072):
    return column_slot(sb // (256 * bpp), r, bpp)


@pytest.mark.parametrize("n_sb,row_w,nb", [
    (4096, record_bound(128, 4), 128),  # sorted-i32.device-frames
    (5274, _column_slot_rows(57336), 64),  # ts-f64.device-column, longest
    (5274, _column_slot_rows(2431), 64),  # and a short superblock of 2,431
    (1, record_bound(1, 1), 1), (3, record_bound(7, 3), 7)])
def test_scratch_layout_regions(n_sb, row_w, nb):
    """The frame mode's scratch regions start aligned, do not overlap and
    hold what K1 writes there: n_sb rows of row_w bytes, n_sb int32 totals,
    n_sb x nb int32 bsizes and fsizes, n_sb + 1 int64 look-back words."""
    lay = scratch_layout(n_sb, row_w, nb)
    assert len(lay) == 6
    need = [n_sb * row_w, 4 * n_sb, 4 * n_sb * nb, 4 * n_sb * nb,
            8 * (n_sb + 1)]
    ends = lay[1:]
    assert lay[0] == 0
    for off, n, end in zip(lay[:5], need, ends):
        assert off % SCRATCH_ALIGN == 0 and off % 16 == 0
        assert end - off >= n and end - off < n + SCRATCH_ALIGN
    assert lay[5] % SCRATCH_ALIGN == 0
