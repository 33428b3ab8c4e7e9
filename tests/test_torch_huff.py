"""The Huffman stream kernels' plain versions (stenos_tpu_torch, CPU) at the
edges of their contract, beside the JAX package's host references.

The decode kernel (csrc/huff_decode.cu) decodes by table: decode_lut_plain,
the lookup it builds, must give v6's (symbol, length) for every 11-bit
window of any table, and a decode by that table, one fresh 11-bit peek a
symbol as the kernel reads, must equal decode_streams_plain (two symbols a
22-bit lookahead) on valid and corrupt anchors. decode_streams_plain is held
to a bit-by-bit canonical decode, and encode_streams_plain to
huf_encode_stream and anchors_host, on anchors past the row and below bit
0, no streams, rows whose width is a multiple of 4 but not of 16, and the
widest row. No Pallas call: a few seconds alone."""

import numpy as np
import pytest
import torch

from stenos_tpu.entropy.huff_decode_pallas import anchors_host
from stenos_tpu.entropy.huffman import build_ctable
from stenos_tpu.entropy.zstd_frame import huf_encode_stream
from stenos_tpu_torch.entropy import huff_decode_kernel, huff_kernel
from stenos_tpu_torch.entropy.huff_decode_kernel import (
    _window22, classify, decode_lut_plain, decode_streams,
    decode_streams_plain, decode_tables, symbols)
from stenos_tpu_torch.entropy.huff_kernel import (SEG, SEGS, STREAM,
                                                  WOUT_WORDS, encode_streams,
                                                  encode_streams_plain)
from stenos_tpu_torch.entropy.huffman import luts_batch

TABLE_KINDS = ["random", "two", "deep", "one", "empty", "noise"]


def _data(rng, kind, n=STREAM):
    """n symbols: a dense spread (random), two symbols, counts halving over
    21 symbols (codes of 11 bits), one symbol."""
    if kind == "random":
        return rng.normal(128, 30, n).clip(0, 255).astype(np.uint8)
    if kind == "two":
        return rng.choice(np.array([3, 250], np.uint8), n, p=[0.9, 0.1])
    if kind == "deep":
        reps = np.maximum((n // 4) >> np.arange(21), 1)
        s = np.repeat(np.arange(21, dtype=np.uint8) * 7, reps)[:n]
        return rng.permutation(np.concatenate([s, np.zeros(n - len(s),
                                                           np.uint8)]))
    return np.full(n, 42, np.uint8)


def _tables(rng, kind, n=3):
    """(n, 304) int32 decode tables: of the data kinds above, of no used
    symbol (empty), or random integers (noise: no code's table)."""
    if kind == "noise":
        return rng.integers(-3000, 3000, (n, 304)).astype(np.int32)
    if kind == "empty":
        return decode_tables(np.zeros((n, 256), np.int32))
    hist = np.stack([np.bincount(_data(rng, kind), minlength=256)
                     for _ in range(n)])
    return decode_tables(luts_batch(hist)[0])


def _encode(rng, kind, ns=1):
    """ns streams of one kind, their LUTs, lengths and encode."""
    data = np.stack([_data(rng, kind) for _ in range(ns)])
    lens, luts = luts_batch(np.stack([np.bincount(d, minlength=256)
                                      for d in data]))
    enc = encode_streams_plain(torch.from_numpy(data),
                               torch.from_numpy(luts), with_anchors=True)
    return data, lens, luts, enc


def _lut_decode(rows, anchors, tables):
    """A decode by the kernel's table: from each anchor, 128 fresh peeks at
    bits [r - 11, r) (zeros below bit 0 and past the row), each giving a
    symbol and the length to step down by."""
    lut = decode_lut_plain(tables).long()
    ns = rows.shape[0]
    buf = torch.cat([rows, torch.zeros((ns, 4), dtype=torch.uint8)], 1).long()
    r = anchors.long()
    out = torch.empty((ns, SEGS, SEG), dtype=torch.int64)
    for k in range(SEG):
        e = torch.gather(lut, 1, _window22(buf, r) >> 11)
        out[:, :, k] = e & 255
        r = r - (e >> 8)
    return out.reshape(ns, STREAM).to(torch.uint8)


def _host_decode(row, anchors, lens):
    """Bit-by-bit canonical decode of one row (a complete code of lengths
    lens): from each anchor, 128 symbols, each the code of the first length
    whose top bits of the window [r - 11, r) are a code of that length."""
    codes, lens = build_ctable(lens)
    book = {(int(ln), int(c)): s for s, (c, ln) in enumerate(zip(codes, lens))
            if ln}
    bits = int.from_bytes(row.tobytes(), "little")
    out = np.zeros(STREAM, np.uint8)
    for g, r in enumerate(int(a) for a in anchors):
        for k in range(SEG):
            lo = r - 11
            W = ((bits >> lo) if lo >= 0 else (bits << -lo)) & 0x7FF
            ln = next(ln for ln in range(1, 12) if (ln, W >> (11 - ln)) in book)
            out[g * SEG + k] = book[ln, W >> (11 - ln)]
            r -= ln
    return out


# -------------------------------------------------------- the decode table
@pytest.mark.parametrize("kind", TABLE_KINDS)
def test_decode_lut_matches_classify(kind):
    """Every 11-bit window: the table's entry is v6's (symbol, length)."""
    tabs = torch.from_numpy(_tables(np.random.default_rng(1), kind))
    lut = decode_lut_plain(tabs)
    assert lut.shape == (3, 2048) and lut.dtype == torch.int32
    tab = tabs.long()
    W = torch.arange(2048).expand(3, -1)
    ln, rank = classify(tab, W)
    assert torch.equal(lut.long() >> 8, ln)
    assert torch.equal(lut.long() & 255, symbols(tab, rank))
    if kind == "deep":
        assert int(ln.max()) == 11


@pytest.mark.parametrize("kind", ["random", "two", "deep", "one"])
def test_lut_decode_matches_plain(kind):
    """The kernel's reading (a fresh peek a symbol) gives v6's symbols, on
    the encoder's anchors and on corrupt ones (past the row, below bit 0,
    at either end of int32)."""
    rng = np.random.default_rng(2)
    data, lens, _, (words, sizes, anchors) = _encode(rng, kind, 2)
    tabs = torch.from_numpy(decode_tables(lens))
    nw = 4 * -(-int(sizes.max()) // 16) + 1  # a width of 4 mod 16 bytes
    rows = words[:, :nw].contiguous().view(torch.uint8)
    bad = torch.from_numpy(rng.integers(-3000, 8 * rows.shape[1] + 3000,
                                        (2, SEGS)).astype(np.int32))
    bad[1, :4] = torch.tensor([2**31 - 1, -2**31, 0, -1])
    for a in (anchors, bad):
        want = decode_streams_plain(rows, a, tabs)
        assert torch.equal(_lut_decode(rows, a, tabs), want)
    assert (decode_streams_plain(rows, anchors, tabs).numpy() == data).all()


# ------------------------------------------- the plain versions at the edges
@pytest.mark.parametrize("where", ["past_the_row", "below_bit_0"])
def test_decode_plain_matches_host_decode(where):
    rng = np.random.default_rng(3)
    _, lens, _, (words, sizes, anchors) = _encode(rng, "random")
    nbytes = 4 * -(-int(sizes[0]) // 4)
    rows = words[:, : nbytes // 4].contiguous().view(torch.uint8)
    a = anchors.clone()
    if where == "past_the_row":
        a[0, ::3] += 8 * nbytes
    else:
        a[0, ::3] = torch.from_numpy(rng.integers(-2000, 12, SEGS // 3 + 1)
                                     .astype(np.int32))
    got = decode_streams_plain(rows, a, torch.from_numpy(decode_tables(lens)))
    assert (got[0].numpy() == _host_decode(rows[0].numpy(), a[0].numpy(),
                                           lens[0])).all()


@pytest.mark.parametrize("width", ["4_mod_16", "widest"])
def test_decode_plain_row_widths(width):
    """Rows 4 bytes past a multiple of 16 and whole 48 KiB rows decode to
    the data, and as the host decode reads them; the wrapper on a CPU
    tensor is the plain version."""
    rng = np.random.default_rng(4)
    data, lens, _, (words, sizes, anchors) = _encode(rng, "deep", 2)
    nbytes = (16 * -(-int(sizes.max()) // 16) + 4 if width == "4_mod_16"
              else 4 * WOUT_WORDS)
    rows = words[:, : nbytes // 4].contiguous().view(torch.uint8)
    assert rows.shape[1] % 16 == (4 if width == "4_mod_16" else 0)
    tabs = torch.from_numpy(decode_tables(lens))
    got = decode_streams(rows, anchors, tabs)
    assert (got.numpy() == data).all()
    assert (got[1].numpy() == _host_decode(rows[1].numpy(),
                                           anchors[1].numpy(), lens[1])).all()
    assert huff_decode_kernel.launches == 0


def test_encode_plain_widest_stream():
    """Every symbol an 11-bit code: the longest bitstream, 360,448 bits and
    the end mark, in the 12,288-word row, as huf_encode_stream writes it."""
    rng = np.random.default_rng(5)
    deep = _data(rng, "deep")
    codes, lens = build_ctable(luts_batch(np.bincount(
        deep, minlength=256)[None])[0][0])
    rare = int(np.flatnonzero(lens == 11)[0])
    data = np.full(STREAM, rare, np.uint8)
    lut = codes.astype(np.int32) | (lens.astype(np.int32) << 11)
    words, sizes, anchors = encode_streams(torch.from_numpy(data[None]),
                                           torch.from_numpy(lut[None]),
                                           with_anchors=True)
    got = words.numpy().view(np.uint8)[0]
    assert int(sizes[0]) == (11 * STREAM + 8) >> 3
    assert got[: int(sizes[0])].tobytes() == huf_encode_stream(data, codes,
                                                               lens)
    assert not got[int(sizes[0]):].any()
    assert (anchors.numpy()[0] == anchors_host(data, lens)).all()
    assert huff_kernel.launches_encode == 0


def test_no_streams():
    """ns == 0: outputs of the contract's shapes, no launch."""
    words, sizes, anchors = encode_streams(
        torch.empty((0, STREAM), dtype=torch.uint8),
        torch.empty((0, 256), dtype=torch.int32), with_anchors=True)
    assert words.shape == (0, WOUT_WORDS) and words.dtype == torch.int32
    assert sizes.shape == (0,) and anchors.shape == (0, SEGS)
    out = decode_streams(torch.empty((0, 64), dtype=torch.uint8),
                         torch.empty((0, SEGS), dtype=torch.int32),
                         torch.empty((0, 304), dtype=torch.int32))
    assert out.shape == (0, STREAM) and out.dtype == torch.uint8
    assert decode_lut_plain(torch.empty((0, 304), dtype=torch.int32)).shape \
        == (0, 2048)
    assert huff_kernel.launches_encode == huff_decode_kernel.launches == 0
