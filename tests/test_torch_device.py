"""The port's device-resident paths (stenos_tpu_torch, CPU) against the JAX
package: the index-mode encode (K1b) and derive-mode decode (K2b) plain
versions against the Pallas kernels in interpret mode, roundtrip_device,
DeviceCompressedArray and compress_frame_device. Exact bytes everywhere.

Interpret-mode Pallas is slow, so it runs in seven calls only: K1b at two
shapes, the JAX round trip (K1b, then K2b in 'jb' order), K2b in 'bj' order,
and one JAX container build and read."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stenos_tpu import frame as ref_frame
from stenos_tpu.device_container import DeviceCompressedArray as RefArray
from stenos_tpu.engine_jax import compress_frame_device_jit
from stenos_tpu.engine_jax import roundtrip_device as ref_roundtrip
from stenos_tpu.native import lib as ref_native
from stenos_tpu.ops.decode_pallas import decode_slabs_derive_body
from stenos_tpu.ops.encode_pallas import encode_slabs_index_body
import stenos_tpu_torch as stt
from stenos_tpu_torch import DeviceCompressedArray, native
from stenos_tpu_torch.engine import (compress_frame_device,
                                     frame_header_bytes, roundtrip_device)
from stenos_tpu_torch.ops.decode_kernel import (decode_rows_derive,
                                                decode_rows_derive_plain,
                                                derive_rowtab_plain)
from stenos_tpu_torch.ops.encode_kernel import (encode_superblocks_index,
                                                encode_superblocks_index_plain,
                                                encode_superblocks_records,
                                                place_records, record_bound)

from conftest import gen_elements
from test_lz_adoption import lz_trigger_bytes

KINDS = ["sorted", "random", "same", "rle", "smallrange"]


@pytest.fixture(autouse=True)
def _no_timing_knobs(monkeypatch):
    # timing-only knobs of the Pallas encode kernel that change its output
    monkeypatch.delenv("STENOS_ENC_KMAX", raising=False)
    monkeypatch.delenv("STENOS_ENC_NOPACK", raising=False)


def _batch(rng, bpp, nb):
    """The five data kinds as five superblocks of nb blocks."""
    sbytes = nb * 256 * bpp
    return np.stack([
        np.frombuffer(gen_elements(rng, bpp, sbytes // bpp + 1, k),
                      np.uint8)[:sbytes] for k in KINDS])


def _array(rng, kind, n):
    return np.frombuffer(gen_elements(rng, 4, n, kind), "<u4")


def _same_records(rows, ref_rows, totals):
    for i, t in enumerate(totals):
        assert rows[i, :t].tobytes() == ref_rows[i, :t].tobytes(), i


# ---------------------------------------------------------------- K1b, K2b
@pytest.mark.usefixtures("no_persistent_cache")
@pytest.mark.parametrize("bpp,nb,level", [(3, 3, 1), (4, 8, 2)])
def test_index_plain_matches_pallas_interpret(rng, bpp, nb, level):
    # (3, 3, 1) runs the JAX kernel's odd-nb padding
    batch = _batch(rng, bpp, nb)
    rows, totals, bsizes, fsizes, po = (
        t.numpy() for t in encode_superblocks_index_plain(
            torch.from_numpy(batch), bpp, level))
    ref = [np.asarray(t) for t in encode_slabs_index_body(
        jnp.asarray(batch), bpp, level, interpret=True)]
    assert np.array_equal(totals, ref[1])
    assert np.array_equal(bsizes, ref[2]) and np.array_equal(fsizes, ref[3])
    assert np.array_equal(po, ref[4])
    _same_records(rows, ref[0], totals)


def test_index_rows_width(rng):
    bpp, nb = 4, 3
    x = torch.from_numpy(_batch(rng, bpp, nb))
    bound = record_bound(nb, bpp)
    assert bound == 4 + nb * (2 + 1024)
    free = encode_superblocks_index(x, bpp, 2)
    wide = encode_superblocks_index(x, bpp, 2, bound)
    assert free[0].shape[1] == int(free[1].max()) and wide[0].shape[1] == bound
    for a, b in zip(free[1:], wide[1:]):
        assert torch.equal(a, b)
    _same_records(wide[0].numpy(), free[0].numpy(), free[1].numpy())
    with pytest.raises(ValueError, match="record bound"):
        encode_superblocks_index(x, bpp, 2, bound - 1)


@pytest.mark.usefixtures("no_persistent_cache")
def test_derive_bj_matches_pallas_interpret(rng):
    """K2b in the parser's 'bj' order, on the index both packages' native
    parsers build for a host frame."""
    bpp, nb, level = 3, 3, 1
    sbytes = nb * 256 * bpp
    raw = np.frombuffer(gen_elements(rng, bpp, sbytes // bpp, "rle"),
                        np.uint8)[:sbytes]
    frame = ref_frame.compress(raw, bpp, level, engine=None)
    assert frame[8] == 1  # method BLOCK
    csize = int.from_bytes(frame[9:12], "little")
    row_bytes = -(-(csize + 512) // 128) * 128
    got = native.load().parse_rows_batch(frame, bpp, sbytes, [12], [csize],
                                         row_bytes)
    want = ref_native.parse_rows_batch(frame, bpp, sbytes, [12], [csize],
                                       row_bytes)
    assert np.array_equal(got[1], want[1])
    words = decode_slabs_derive_body(jnp.asarray(want[0]),
                                     jnp.asarray(want[1]), bpp, nb, "bj",
                                     interpret=True)
    ref = np.ascontiguousarray(np.asarray(words)).view(np.uint8).reshape(-1)
    vbufs, po = torch.from_numpy(got[0]), torch.from_numpy(got[1])
    out = decode_rows_derive_plain(vbufs, po, bpp, nb, "bj")
    assert out.numpy().tobytes() == ref.tobytes() == raw.tobytes()
    # the derived records are the parser's own
    _, rowtab = derive_rowtab_plain(vbufs, po, bpp, nb, "bj")
    assert np.array_equal(rowtab.numpy(), got[2])
    assert torch.equal(decode_rows_derive(vbufs, po, bpp, nb, "bj"), out)


def test_derive_orders_agree(rng):
    """'jb' on the encoder's index and 'bj' on the same index reordered."""
    bpp, nb = 4, 3
    batch = _batch(rng, bpp, nb)
    rows, _, _, _, po = encode_superblocks_index_plain(
        torch.from_numpy(batch), bpp, 2)
    po_bj = po.reshape(len(batch), bpp, nb).transpose(1, 2).reshape(
        len(batch), -1).contiguous()
    jb = decode_rows_derive(rows, po, bpp, nb, "jb")
    assert jb.numpy().tobytes() == batch.tobytes()
    assert torch.equal(decode_rows_derive(rows, po_bj, bpp, nb, "bj"), jb)
    with pytest.raises(ValueError, match="plane_order"):
        decode_rows_derive(rows, po, bpp, nb, "xy")


def test_derive_reads_stay_in_the_row(rng):
    """A corrupt index points plane 0 of block 0 near the row's end: the
    decode reads zeros past the row, and every other plane is intact."""
    bpp, nb = 2, 2
    batch = _batch(rng, bpp, nb)
    rows, _, _, _, po = encode_superblocks_index_plain(
        torch.from_numpy(batch), bpp, 2)
    bad = po.clone()
    bad[:, 0] = (bad[:, 0] & ~0xFFFFFF) | (rows.shape[1] - 3)
    out = decode_rows_derive(rows, bad, bpp, nb, "jb").numpy()
    hit = np.zeros(batch.shape[1], bool)
    hit[: 256 * bpp : bpp] = True  # plane 0 of block 0
    assert np.array_equal(out[:, ~hit], batch[:, ~hit])


# --------------------------------------------------------- roundtrip_device
@pytest.mark.usefixtures("no_persistent_cache")
def test_roundtrip_matches_jax(rng):
    """Records and totals against the JAX round trip, whose decode is the
    Pallas K2b in 'jb' order on K1b's index."""
    bpp, nb = 4, 8
    batch = _batch(rng, bpp, nb)
    words, rows, totals = ref_roundtrip(jnp.asarray(batch), bpp, 2,
                                        interpret=True)
    ref = np.ascontiguousarray(np.asarray(words)).view(np.uint8)
    out, prow, ptot = roundtrip_device(torch.from_numpy(batch), bpp, 2)
    assert np.array_equal(ptot.numpy(), np.asarray(totals))
    _same_records(prow.numpy(), np.asarray(rows), ptot.numpy())
    assert out.numpy().tobytes() == ref.tobytes() == batch.tobytes()


@pytest.mark.parametrize("bpp", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["sorted", "random", "same", "rle"])
def test_roundtrip_device(rng, bpp, kind):
    nb, n_sb = 4, 2
    sbytes = nb * 256 * bpp
    raw = np.frombuffer(gen_elements(rng, bpp, n_sb * sbytes // bpp, kind),
                        np.uint8)[: n_sb * sbytes]
    x = torch.from_numpy(raw.copy()).view(n_sb, sbytes)
    out, rows, totals = roundtrip_device(x, bpp, 2)
    assert out.numpy().tobytes() == raw.tobytes(), (bpp, kind)
    # rows at the record bound, zeros past each record: no host read
    assert rows.shape[1] == record_bound(nb, bpp)
    past = torch.arange(rows.shape[1]) >= totals[:, None]
    assert not rows[past].any()
    # the rows are frame records: the host path decodes one
    hdr = bytes([0]) + sbytes.to_bytes(7, "little")
    rec = rows[1, : int(totals[1])].numpy().tobytes()
    assert ref_frame.decompress(hdr + rec, bpp).tobytes() == raw[sbytes:].tobytes()


# ----------------------------------------------------- DeviceCompressedArray
@pytest.mark.usefixtures("no_persistent_cache")
def test_container_matches_jax(rng):
    a = _array(rng, "sorted", 5000)
    ref = RefArray.from_array(a, slab_elems=1024)
    arr = DeviceCompressedArray.from_array(a, slab_elems=1024, device="cpu")
    assert arr.slab_bytes == ref.slab_bytes and arr.n_slabs == ref.n_slabs
    assert arr.serialize() == ref.serialize()
    assert arr.memory_footprint() == ref.memory_footprint()
    assert arr.to_array().tobytes() == ref.to_array().tobytes() == a.tobytes()


@pytest.mark.parametrize("kind", ["sorted", "random", "rle"])
def test_container_reads(rng, kind):
    a = _array(rng, kind, 3000 + 977)
    arr = DeviceCompressedArray.from_array(a, slab_elems=1024, device="cpu")
    assert len(arr) == len(a) and arr.n_slabs == 3
    assert np.array_equal(arr.to_array(), a)
    assert arr.slab(2).dtype == torch.uint8
    assert arr.slab(2).numpy().tobytes() == a[2048:3072].tobytes()
    for i in (0, 17, 1023, 1024, 3071, 3072, len(a) - 1, -1, -len(a)):
        assert arr[i] == a[i], i
    with pytest.raises(IndexError):
        arr[len(a)]
    assert np.array_equal(arr[100:3500:7], a[100:3500:7])
    assert np.array_equal(arr[::-1], a[::-1])
    blob = arr.serialize()
    assert ref_frame.decompress(blob, 4).tobytes() == a.tobytes()
    assert stt.decompress(blob, 4, engine=None).tobytes() == a.tobytes()


def test_container_compresses(rng):
    # default slabs of 128 blocks amortize the row bucket and the index
    a = _array(rng, "smallrange", 96 * 1024)
    arr = DeviceCompressedArray.from_array(a, device="cpu")
    assert arr.n_slabs == 3
    assert arr.memory_footprint() == (arr._rows.numel()
                                      + 4 * arr._plane_off.numel())
    assert arr.current_compression_ratio() > 2.0
    assert np.array_equal(arr.to_array(), a)


def test_container_small_and_wide(rng):
    # fewer elements than one slab: all tail
    a = _array(rng, "random", 700)
    arr = DeviceCompressedArray.from_array(a, device="cpu")
    assert arr.n_slabs == 0 and np.array_equal(arr.to_array(), a)
    assert arr[699] == a[699]
    assert ref_frame.decompress(arr.serialize(), 4).tobytes() == a.tobytes()
    # bpp 8: default slabs of 128 blocks cap at 1024 // 8
    b = np.frombuffer(gen_elements(rng, 8, 40000, "sorted"), "<u8")
    arr = DeviceCompressedArray.from_array(b, device="cpu")
    ref = RefArray.from_array(b)
    assert arr.slab_bytes == ref.slab_bytes == 128 * 256 * 8
    assert arr.serialize() == ref.serialize()
    assert np.array_equal(arr.to_array(), b)


def test_deserialize_custom_shift_frame(rng):
    a = _array(rng, "sorted", 4096)
    frame = ref_frame.compress(a.view(np.uint8), 4, 1, custom_shift=2)
    arr = DeviceCompressedArray.deserialize(frame, "<u4", device="cpu")
    assert arr._order == "bj"
    assert np.array_equal(arr.to_array(), a)
    assert arr[4095] == a[4095]
    assert arr.serialize() == RefArray.deserialize(frame, "<u4").serialize()
    assert ref_frame.decompress(arr.serialize(), 4).tobytes() == a.tobytes()


def test_deserialize_lz_frame(rng):
    # LZ blocks make the virtual streams longer than the records
    raw = lz_trigger_bytes(rng, 3, 131072)
    frame = ref_frame.compress(raw, 4, 1, engine=None)
    arr = DeviceCompressedArray.deserialize(frame, np.uint32, device="cpu")
    assert (arr._totals - 4 > np.diff(_record_offsets(frame)) - 4).any()
    assert arr.to_array().view(np.uint8).tobytes() == raw.tobytes()
    blob = arr.serialize()
    assert blob == RefArray.deserialize(frame, np.uint32).serialize()
    assert ref_frame.decompress(blob, 4).tobytes() == raw.tobytes()
    again = DeviceCompressedArray.deserialize(blob, np.uint32, device="cpu")
    assert again.to_array().view(np.uint8).tobytes() == raw.tobytes()


def _record_offsets(frame):
    dsize, sb, pos = ref_frame.get_info(frame, 4)
    offs = [pos]
    for _ in range(dsize // sb):
        offs.append(offs[-1] + 4 + int.from_bytes(
            frame[offs[-1] + 1 : offs[-1] + 4], "little"))
    return np.asarray(offs)


def test_deserialize_tail_and_other_methods(rng):
    # a short last superblock decodes alone; the rest stays BLOCK records
    a = _array(rng, "sorted", 3 * 1024 + 300)
    frame = ref_frame.compress(a.view(np.uint8), 4, 1, custom_shift=2)
    arr = DeviceCompressedArray.deserialize(frame, "<u4", device="cpu")
    assert arr.n_slabs == 3 and len(arr._tail) == 1200
    assert np.array_equal(arr.to_array(), a)
    assert ref_frame.decompress(arr.serialize(), 4).tobytes() == a.tobytes()
    # a frame that is not all method BLOCK is decoded and encoded anew
    b = _array(rng, "random", 70000)
    frame = ref_frame.compress(b.view(np.uint8), 4, 3, engine=None)
    assert any(frame[p] != 1 for p in _record_offsets(frame)[:-1])
    arr = DeviceCompressedArray.deserialize(frame, "<u4", device="cpu")
    assert arr._records is None and np.array_equal(arr.to_array(), b)


def test_container_refuses_what_it_lacks(rng):
    a = _array(rng, "sorted", 3000)
    # under one slab there are no records for the entropy stage to code
    arr = DeviceCompressedArray.from_array(a, entropy=True, device="cpu")
    assert arr._entropy is None and np.array_equal(arr.to_array(), a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceCompressedArray.from_array(a)


# --------------------------------------------------- compress_frame_device
@pytest.mark.parametrize("bpp,sb,n_sb,kind", [(4, 2048, 16, "sorted"),
                                              (2, 1536, 5, "random")])
def test_compress_frame_device_matches_jax(rng, bpp, sb, n_sb, kind):
    data = gen_elements(rng, bpp, n_sb * sb // bpp, kind)
    batch = np.frombuffer(data, np.uint8).reshape(n_sb, sb)
    ref, ref_len = compress_frame_device_jit(batch, bpp, 1)
    frame, length = compress_frame_device(torch.from_numpy(batch.copy()),
                                          bpp, 1)
    assert int(length) == int(ref_len)
    got = frame[: int(length)].numpy().tobytes()
    assert got == np.asarray(ref)[: int(ref_len)].tobytes()
    assert stt.decompress(got, bpp, device="cpu").tobytes() == data
    assert ref_frame.decompress(got, bpp).tobytes() == data
    # zeros past the frame, up to the capacity of n_sb record bounds
    assert not frame[int(length):].any()
    nb = sb // (256 * bpp)
    hdr = frame_header_bytes(n_sb * sb, sb, bpp, 1)
    assert frame.shape[0] == len(hdr) + n_sb * record_bound(nb, bpp)
    # the public place_records (it zeroes the tail itself) on the records
    # mode's rows: the same frame and zeros, to the same capacity
    rows, totals = encode_superblocks_records(torch.from_numpy(batch.copy()),
                                              bpp, 2)[:2]
    placed, placed_len = place_records(rows, totals - 4, hdr, nb, bpp)
    assert int(placed_len) == int(ref_len) and torch.equal(placed, frame)
