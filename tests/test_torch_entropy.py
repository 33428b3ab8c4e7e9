"""The port's entropy stage (stenos_tpu_torch, CPU) against the JAX package:
the Huffman table functions, the histogram (K3), stream-encode (K4) and
anchored-decode (K5) plain versions, and DeviceCompressedArray(entropy=True).
Exact bytes everywhere.

Interpret-mode Pallas is slow, so the JAX kernels run in three calls only:
the histogram on one block, the stream encode on one batch of streams, and
one JAX container build (its K1b, histogram and stream encode). The port's
decode is held to decode(encode(x)) == x and its container's reads to the
input; its serialize() to the entropy=False container's frame, which
tests/test_torch_device.py holds to the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stenos_tpu import frame as ref_frame
from stenos_tpu.device_container import DeviceCompressedArray as RefArray
from stenos_tpu.entropy.huff_decode_pallas import anchors_host
from stenos_tpu.entropy.huff_decode_pallas import decode_tables as ref_tables
from stenos_tpu.entropy.huff_pallas import (encode_streams_device,
                                            histogram_device)
from stenos_tpu.entropy.huffman import build_ctable, code_lengths
from stenos_tpu.entropy.zstd_frame import huf_encode_stream
from stenos_tpu_torch import DeviceCompressedArray
from stenos_tpu_torch.entropy import huff_decode_kernel, huff_kernel
from stenos_tpu_torch.entropy.huff_decode_kernel import (decode_streams,
                                                         decode_streams_plain,
                                                         decode_tables)
from stenos_tpu_torch.entropy.huff_kernel import (BLOCK, STREAM, WOUT_WORDS,
                                                  encode_streams,
                                                  encode_streams_plain,
                                                  histogram, histogram_plain)
from stenos_tpu_torch.device_container import record_blocks
from stenos_tpu_torch.entropy.huffman import (build_ctables_batch,
                                              code_lengths_batch, luts_batch)

STREAM_KINDS = ["normal", "two", "deep", "one"]


def _counts(rng, k, n=3):
    """n histograms of test_entropy_pallas.py's kind k: dense, 9 symbols,
    zipf, a band of 76 symbols."""
    counts = np.zeros((n, 256), np.int64)
    for i in range(n):
        if k == 0:
            counts[i] = rng.integers(0, 1000, 256)
        elif k == 1:
            counts[i, rng.choice(256, 9, replace=False)] = rng.integers(
                1, 1 << 20, 9)
        elif k == 2:
            counts[i] = np.bincount(
                (rng.zipf(1.2, 50000).clip(1, 256) - 1), minlength=256)
        else:
            counts[i, 180:256] = rng.integers(1, 50, 76)
    return counts


def _stream(rng, kind):
    if kind == "normal":
        return rng.normal(128, 20, STREAM).clip(0, 255).astype(np.uint8)
    if kind == "two":
        return rng.choice(np.array([3, 250], np.uint8), STREAM, p=[0.9, 0.1])
    if kind == "deep":  # counts halving over 21 symbols: lengths capped at 11
        reps = np.maximum(8192 >> np.arange(21), 1)
        s = np.repeat(np.arange(21, dtype=np.uint8) * 7, reps)
        s = np.concatenate([s, np.zeros(STREAM - len(s), np.uint8)])
        return rng.permutation(s)
    return np.full(STREAM, 42, np.uint8)


def _lut(data):
    """The JAX package's table for data: (codes, lengths, LUT code |
    len << 11)."""
    codes, lens = build_ctable(code_lengths(np.bincount(data, minlength=256)))
    return codes, lens, codes.astype(np.int32) | (lens.astype(np.int32) << 11)


def _low_card(rng, n):
    """tests/test_device_container.py's low-cardinality column: 30 symbols
    97..126, p ~ 1/k."""
    p = 1.0 / np.arange(1, 31)
    return rng.choice(np.arange(97, 127, dtype=np.uint8), size=n,
                      p=p / p.sum())


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("k", range(4))
def test_tables_match_jax(rng, k):
    counts = _counts(rng, k)
    lens = code_lengths_batch(counts)
    codes = build_ctables_batch(lens)
    tabs = decode_tables(lens)
    lens2, luts = luts_batch(counts)
    assert lens.dtype == np.int32 and tabs.shape == (3, 304)
    assert (lens2 == lens).all() and luts.dtype == np.int32
    for i in range(len(counts)):
        assert (lens[i] == code_lengths(counts[i])).all(), i
        assert (codes[i] == build_ctable(lens[i])[0]).all(), i
        assert (tabs[i] == ref_tables(lens[i])[0]).all(), i
        ref_codes, ref_lens = build_ctable(lens[i])
        assert (luts[i] == (ref_codes.astype(np.int32)
                            | (ref_lens.astype(np.int32) << 11))).all(), i


# --------------------------------------------------------------- histogram
def test_histogram_plain_matches_pallas(rng):
    data = _low_card(rng, BLOCK)
    got = histogram_plain(torch.from_numpy(data.reshape(1, -1)))
    want = np.asarray(histogram_device(jnp.asarray(data.reshape(1, -1)),
                                       interpret=True))
    assert got.dtype == torch.int32 and (got.numpy() == want).all()


def test_histogram_plain_blocks(rng):
    blocks = np.stack([rng.integers(0, 256, BLOCK).astype(np.uint8),
                       np.zeros(BLOCK, np.uint8), _low_card(rng, BLOCK)])
    got = histogram(torch.from_numpy(blocks))  # a CPU tensor: the plain one
    want = np.stack([np.bincount(b, minlength=256) for b in blocks])
    assert (got.numpy() == want).all()
    assert huff_kernel.launches_histogram == 0


@pytest.mark.parametrize("chunk_bytes", [1, 20_000, 1 << 25])
def test_record_blocks(rng, chunk_bytes):
    """The records back to back, then zeros to whole blocks, whether the
    gather takes one row, a few or all of them at a time."""
    rows = rng.integers(0, 256, (40, 9000)).astype(np.uint8)
    totals = rng.integers(0, 9001, 40)
    totals[[0, 7]] = (9000, 0)
    body = b"".join(r[:t].tobytes() for r, t in zip(rows, totals))
    got = record_blocks(torch.from_numpy(rows), totals, chunk_bytes)
    assert got.shape == (-(-len(body) // BLOCK), BLOCK)
    flat = got.numpy().reshape(-1)
    assert flat[:len(body)].tobytes() == body and not flat[len(body):].any()


# ------------------------------------------------------------ stream encode
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_encode_plain_matches_host(rng, kind):
    data = _stream(rng, kind)
    codes, lens, lut = _lut(data)
    if kind == "deep":
        assert lens.max() == 11
    words, sizes, anchors = encode_streams(
        torch.from_numpy(data[None]), torch.from_numpy(lut[None]),
        with_anchors=True)
    assert words.shape == (1, WOUT_WORDS) and words.dtype == torch.int32
    got = words.numpy().view(np.uint8)[0]
    size = int(sizes[0])
    assert got[:size].tobytes() == huf_encode_stream(data, codes, lens)
    assert not got[size:].any()
    assert (anchors.numpy()[0] == anchors_host(data, lens)).all()
    assert huff_kernel.launches_encode == 0


def test_encode_plain_matches_pallas(rng):
    data = np.stack([_stream(rng, k) for k in STREAM_KINDS])
    luts = np.stack([_lut(d)[2] for d in data])
    want = encode_streams_device(jnp.asarray(data), jnp.asarray(luts),
                                 interpret=True, with_anchors=True)
    got = encode_streams_plain(torch.from_numpy(data),
                               torch.from_numpy(luts), with_anchors=True)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()


# ------------------------------------------------------------ stream decode
@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_decode_plain_roundtrip(rng, kind):
    data = np.stack([_stream(rng, kind), _stream(rng, kind)])
    lens = np.stack([_lut(d)[1] for d in data])
    luts = np.stack([_lut(d)[2] for d in data])
    words, sizes, anchors = encode_streams_plain(
        torch.from_numpy(data), torch.from_numpy(luts), with_anchors=True)
    tabs = torch.from_numpy(decode_tables(lens))
    wbucket = -(-int(sizes.max()) // 512) * 512
    for width in (wbucket, 4 * WOUT_WORDS):  # the store's rows, whole rows
        rows = words[:, : width // 4].contiguous().view(torch.uint8)
        out = decode_streams(rows, anchors, tabs)
        assert out.dtype == torch.uint8 and out.shape == (2, STREAM)
        assert (out.numpy() == data).all(), width
    assert huff_decode_kernel.launches == 0


def test_decode_plain_zeros_past_the_row(rng):
    # anchors past the row's bytes read zeros, as the kernel's reads do
    data = _stream(rng, "normal")[None]
    lens, lut = _lut(data[0])[1:]
    words, sizes, anchors = encode_streams_plain(
        torch.from_numpy(data), torch.from_numpy(lut[None]),
        with_anchors=True)
    short = words[:, :64].contiguous().view(torch.uint8)
    zero = torch.zeros((1, 1024), dtype=torch.uint8)
    zero[:, :256] = short
    tabs = torch.from_numpy(decode_tables(lens[None]))
    assert torch.equal(decode_streams_plain(short, anchors, tabs),
                       decode_streams_plain(zero, anchors, tabs))


# ------------------------------------------------- DeviceCompressedArray
@pytest.fixture(scope="module")
def containers():
    """One input, about 384 KiB: 9 slabs of the low-cardinality column (Huffman
    pays) and 3 of uniform nibbles (records of packed 4-bit planes: it does
    not). Records are ~21.8 and ~18.8 KB, so the row bucket (22,528 B) is
    below both packages' full row widths; the records fill 2 blocks, the
    first coded and the second raw, and the stage is kept."""
    rng = np.random.default_rng(3)
    d = np.concatenate([_low_card(rng, 9 * 32768),
                        rng.integers(0, 16, 3 * 32768).astype(np.uint8)])
    ref = RefArray.from_array(d, entropy=True)
    arr = DeviceCompressedArray.from_array(d, entropy=True, device="cpu")
    return d, ref, arr


def test_container_store_matches_jax(containers):
    d, ref, arr = containers
    e, f = arr._entropy, ref._entropy
    assert e is not None and f is not None and arr._rows is None
    assert e.rb == f.rb == 22528 and arr.n_slabs == ref.n_slabs == 12
    assert (e.flags == f.flags).all() and list(e.flags) == [True, False]
    assert (e.offs == f.offs).all() and (e.totals == f.totals).all()
    assert (e.sizes == np.asarray(f.sizes)).all()
    assert e.words.shape == f.words.shape
    assert (e.words.numpy() == np.asarray(f.words)).all()
    assert (e.anchors.numpy() == np.asarray(f.anchors)).all()
    assert (e.tabs.numpy() == np.asarray(f.tabs)).all()
    assert (e.raw.numpy() == np.stack([np.asarray(f.raw[b])
                                       for b in sorted(f.raw)])).all()
    assert arr.memory_footprint() == ref.memory_footprint()
    plain = DeviceCompressedArray.from_array(d, device="cpu")
    assert arr.memory_footprint() < plain.memory_footprint()


def test_container_entropy_reads(containers):
    d, _, arr = containers
    assert np.array_equal(arr.to_array(), d)
    sb = arr.slab_bytes
    for i in (0, 3, 8, 9, 11):  # coded, across the block edge, raw
        got = arr.slab(i).numpy().tobytes()
        assert got == d[i * sb:(i + 1) * sb].tobytes(), i
    for i in (0, 123_456, 9 * sb - 1, 9 * sb, len(d) - 1, -1):
        assert arr[i] == d[i], i
    assert np.array_equal(arr[1000:300_000:13], d[1000:300_000:13])


def test_container_entropy_serialize(containers):
    d, _, arr = containers
    blob = arr.serialize()
    plain = DeviceCompressedArray.from_array(d, device="cpu")
    assert blob == plain.serialize()
    assert ref_frame.decompress(blob, 1, engine=None).tobytes() == d.tobytes()
    back = DeviceCompressedArray.deserialize(blob, np.uint8, device="cpu")
    assert np.array_equal(back.to_array(), d)


def test_container_entropy_bails_when_unprofitable():
    # test_device_container.py's data: block-codec records of a random walk
    # are near-uniform bytes, Huffman cannot beat the row store
    d = np.cumsum(np.random.default_rng(12345).normal(0, 80, 200_000)).astype(
        "<i4")
    arr = DeviceCompressedArray.from_array(d, entropy=True, device="cpu")
    assert arr._entropy is None and arr._rows is not None
    assert np.array_equal(arr.to_array(), d)
