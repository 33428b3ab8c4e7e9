"""The decode kernel's plain torch version (stenos_tpu_torch, CPU) on the
port's own native row parser, against the raw bytes, the JAX package's
parser and its Pallas decode kernel in interpret mode. Frames come from the
host compressor (bit-exact with the C++ reference)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stenos_tpu import frame as fr
from stenos_tpu.native import lib as ref_native
from stenos_tpu.ops.decode_pallas import decode_slabs_body
from stenos_tpu_torch import native
from stenos_tpu_torch.ops.decode_kernel import decode_rows, decode_rows_plain

from conftest import gen_elements

CASES = ((1, 2), (3, 1), (8, 2))  # (nb, level), as test_decode_pallas.py


def _parsed(rng, bpp, kind, nb, level):
    """(raw, frame, both parsers' batched index) or None if the frame's
    record is not method BLOCK."""
    sbytes = nb * 256 * bpp
    raw = np.frombuffer(gen_elements(rng, bpp, sbytes // bpp, kind),
                        np.uint8)[:sbytes]
    stream = fr.compress(raw, bpp, level, engine=None)
    if stream[8] != 1:
        return None
    csize = int.from_bytes(stream[9:12], "little")
    row_bytes = -(-(csize + 512) // 128) * 128
    got = native.load().parse_rows_batch(stream, bpp, sbytes, [12], [csize],
                                         row_bytes)
    want = ref_native.parse_rows_batch(stream, bpp, sbytes, [12], [csize],
                                       row_bytes)
    assert not isinstance(got, int) and not isinstance(want, int)
    return raw, got, want


@pytest.mark.parametrize("bpp", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["sorted", "random", "same", "rle"])
def test_plain_decodes_port_parse(rng, bpp, kind):
    for nb, level in CASES:
        r = _parsed(rng, bpp, kind, nb, level)
        if r is None:
            continue
        raw, got, want = r
        for a, b in zip(got, want):
            assert np.array_equal(a, b), (bpp, kind, nb, level)
        vbufs, plane_off, rowtab, _ = (torch.from_numpy(a) for a in got)
        out = decode_rows_plain(vbufs, plane_off, rowtab, bpp, nb)
        assert out.numpy().tobytes() == raw.tobytes(), (bpp, kind, nb, level)
        assert torch.equal(decode_rows(vbufs, plane_off, rowtab, bpp, nb), out)


@pytest.mark.usefixtures("no_persistent_cache")
@pytest.mark.parametrize("bpp,kind,nb,level", [(3, "rle", 3, 1)])
def test_plain_matches_pallas_interpret(rng, bpp, kind, nb, level):
    r = _parsed(rng, bpp, kind, nb, level)
    assert r is not None
    raw, got, want = r
    words = decode_slabs_body(jnp.asarray(want[0]), jnp.asarray(want[1]),
                              jnp.asarray(want[2]), bpp, nb, interpret=True)
    ref = np.ascontiguousarray(np.asarray(words)).view(np.uint8).reshape(-1)
    out = decode_rows_plain(*(torch.from_numpy(a) for a in got[:3]), bpp, nb)
    assert out.numpy().tobytes() == ref.tobytes() == raw.tobytes()
