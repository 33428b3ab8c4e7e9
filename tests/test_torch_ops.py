"""Torch twins of the block-codec primitives (stenos_tpu_torch) against the
stenos_tpu functions they are ported from, called with xp=np. Integer
codec: every comparison is exact."""

import numpy as np
import pytest
import torch

from stenos_tpu.codec import analyze as ref_analyze
from stenos_tpu.codec import emit as ref_emit
from stenos_tpu.ops import bitpack as ref_bitpack
from stenos_tpu.ops import compact as ref_compact
from stenos_tpu_torch.codec import analyze, emit
from stenos_tpu_torch.ops import bitpack
from stenos_tpu_torch.ops.compact import compact

from conftest import gen_elements


def _eq(t, a):
    assert np.array_equal(t.numpy(), np.asarray(a).astype(t.numpy().dtype))


def _one_block(rng, bpp, kind):
    raw = np.frombuffer(gen_elements(rng, bpp, 257, kind), np.uint8)
    el = raw[: 256 * bpp].reshape(1, 256, bpp).astype(np.int32)
    x = el.transpose(0, 2, 1).reshape(1, bpp, 16, 16)
    return x, el[:, 0, :]


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("kind", ["sorted", "random", "same", "rle",
                                  "smallrange"])
def test_analyze_and_emit_twins(rng, bpp, kind):
    x, firsts = _one_block(rng, bpp, kind)
    xt, ft = torch.from_numpy(x), torch.from_numpy(firsts)
    for level in (0, 1, 2):
        want = ref_analyze.analyze_planes(np, x, firsts, level >= 1)
        got = analyze.analyze_planes_torch(xt, ft, level >= 1)
        assert want.keys() == got.keys()
        for k in want:
            _eq(got[k], want[k])
        codes, sizes = ref_analyze.plane_kinds(np, want, level)
        tcodes, tsizes = analyze.plane_kinds_torch(got, level)
        _eq(tcodes, codes)
        _eq(tsizes, sizes)

        sec = ref_emit.plane_sections(np, x, want, codes, firsts)
        tsec = emit.plane_sections_torch(xt, got, tcodes, ft)
        assert sec.keys() == tsec.keys()
        for k in sec:
            _eq(tsec[k], sec[k])
        _eq(emit.block_header_bytes_torch(tcodes, bpp),
            ref_emit.block_header_bytes(np, codes, bpp))


def test_compact_twin(rng):
    for width in (16, 300):
        values = rng.integers(0, 256, (7, width)).astype(np.int32)
        valid = rng.random((7, width)) < 0.4
        valid[0] = False
        valid[1] = True
        want, wn = ref_compact.compact(np, values, valid)
        got, gn = compact(torch.from_numpy(values), torch.from_numpy(valid))
        _eq(got, want)
        _eq(gn, wn)


def test_bitpack_twins(rng):
    for b in range(1, 7):
        v = rng.integers(0, 1 << b, (9, 16)).astype(np.int32)
        packed = ref_bitpack.pack16(np, v, b)
        _eq(bitpack.pack16_torch(torch.from_numpy(v), b), packed)
        _eq(bitpack.unpack16_torch(torch.from_numpy(packed), b),
            ref_bitpack.unpack16(np, packed, b))
    bits = rng.integers(0, 9, 40)
    v = rng.integers(0, 256, (40, 16)).astype(np.int32)
    v &= ((1 << np.clip(bits, 0, 6)) - 1)[:, None]
    _eq(bitpack.pack16_any_torch(torch.from_numpy(v), torch.from_numpy(bits)),
        ref_bitpack.pack16_any(np, v, bits))
