"""The port's CompressedArray (stenos_tpu_torch, CPU) against the JAX
package's container: serialize() byte for byte after the same calls, and
the behaviours of tests/test_container.py and tests/test_foreach_threads.py
(the LRU pool, apply / for_each and their backward and read-only variants,
insert, erase, resize, the stream variants, the metrics, a 16-thread
stress). The port runs with engine=None (the numpy host path) and with
TorchEngine("cpu"), where each chunk encodes and decodes through the
kernels' plain versions. The C++-oracle case of tests/test_container.py is
left out (the oracle library is not available to the tests)."""

import io
import sys
import threading

import numpy as np
import pytest
import torch

import stenos_tpu as st
import stenos_tpu_torch as stt
from stenos_tpu.container import CompressedArray as RefArray
from stenos_tpu_torch.container import CompressedArray
from stenos_tpu_torch.engine import TorchEngine

ENGINES = ["host", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this worker while the module runs: the plain
    versions run on small inputs, and the suite's other workers hold the
    cores, where torch's thread pool slows them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(kind):
    return None if kind == "host" else TorchEngine("cpu")


def _pair(eng, dtype=np.int32, **kw):
    """The port's container and the JAX package's, the same settings."""
    return (CompressedArray(dtype, engine=_engine(eng), **kw),
            RefArray(dtype, **kw))


def _mutate(kind, v, rng):
    """One kind of mutation, the same calls on any container."""
    if kind == "extend":
        v.extend(np.sort(rng.integers(0, 1 << 20, 3000)).astype(np.int32))
    elif kind == "setitem":
        v[5:900:7] = np.arange(128, dtype=np.int32)
        v[4000] = -1
        v[-1] = 7
    elif kind == "insert":
        v.insert(100, 7)
        v.insert(0, [1, 2, 3])
        v.insert(len(v), 99)
        v.insert(2100, np.arange(600, dtype=np.int32))
    elif kind == "erase":
        v.erase(50)
        v.erase(10, 700)
        v.erase(len(v) - 300, len(v))
    elif kind == "resize":
        v.resize(len(v) - 500)
        v.resize(len(v) + 1234, fill=-5)
        v.pop_back()


@pytest.mark.parametrize("kind", ["extend", "setitem", "insert", "erase",
                                  "resize"])
@pytest.mark.parametrize("eng", ENGINES)
def test_serialize_matches_jax_after_mutation(eng, kind):
    rng = np.random.default_rng(21)
    data = np.sort(rng.integers(0, 1 << 30, 5000)).astype(np.int32)
    v, ref = _pair(eng, level=2, block_shift=2, max_raw_buckets=3)
    v.extend(data)
    ref.extend(data)
    _mutate(kind, v, np.random.default_rng(1))
    _mutate(kind, ref, np.random.default_rng(1))
    assert len(v) == len(ref)
    blob = v.serialize()
    assert blob == ref.serialize()
    assert np.array_equal(v.to_numpy(), ref.to_numpy())
    assert np.array_equal(stt.decompress(blob, 4, engine=None).view(np.int32),
                          ref.to_numpy())


@pytest.mark.parametrize("eng", ENGINES)
def test_deserialize_custom_shift_frame(eng):
    """A custom-shift frame (what cvector writes) is adopted bucket by
    bucket and reads back; serialize gives the frame's records again."""
    rng = np.random.default_rng(2)
    data = rng.integers(0, 1 << 16, 10000).astype(np.uint16)
    f = stt.compress(data.tobytes(), 2, 1, engine=_engine(eng),
                     custom_shift=4)
    assert f == st.compress(data.tobytes(), 2, 1, custom_shift=4)
    w = CompressedArray.deserialize(f, np.uint16, engine=_engine(eng))
    assert w.block_shift == 4 and len(w) == len(data)
    assert w[1234] == data[1234]
    assert np.array_equal(w.to_numpy(), data)
    r = RefArray.deserialize(f, np.uint16)
    assert w.serialize() == r.serialize()
    w2 = CompressedArray.deserialize_from(io.BytesIO(f), np.uint16,
                                          engine=_engine(eng))
    assert np.array_equal(w2.to_numpy(), data)


@pytest.mark.parametrize("eng", ENGINES)
def test_strong_debug_flag(eng, monkeypatch):
    """STENOS_STRONG_DEBUG=1: every chunk compression is decoded back, the
    bytes unchanged (the JAX container's under the flag)."""
    monkeypatch.setenv("STENOS_STRONG_DEBUG", "1")
    rng = np.random.default_rng(3)
    data = np.sort(rng.integers(0, 1 << 30, 2048)).astype(np.int32)
    v, ref = _pair(eng, level=2)
    v.extend(data)
    ref.extend(data)
    blob = v.serialize()
    assert blob == ref.serialize()
    assert np.array_equal(stt.decompress(blob, 4, engine=None).view(np.int32),
                          data)


@pytest.mark.parametrize("eng", ENGINES)
def test_append_index_roundtrip(eng):
    rng = np.random.default_rng(4)
    v = CompressedArray(np.int32, level=2, engine=_engine(eng))
    ref = []
    for x in rng.integers(0, 1 << 30, 3000):
        v.append(x)
        ref.append(int(x))
    assert len(v) == 3000
    assert v[0] == ref[0] and v[-1] == ref[-1] and v.at(5) == ref[5]
    for i in rng.integers(0, 3000, 100):
        assert v[int(i)] == ref[int(i)]
    assert np.array_equal(v.to_numpy(), np.array(ref, np.int32))
    with pytest.raises(IndexError):
        v[3000]


def test_extend_slices_setitem():
    rng = np.random.default_rng(5)
    data = np.sort(rng.integers(0, 1 << 40, 70001)).astype(np.int64)
    v = CompressedArray(np.int64, block_shift=2, level=1, engine=None)
    v.extend(data)
    assert np.array_equal(v[100:200], data[100:200])
    assert np.array_equal(v[::777], data[::777])
    assert np.array_equal(v[5000:100:-3], data[5000:100:-3])
    v[5:10] = np.arange(5, dtype=np.int64)
    data[5:10] = np.arange(5)
    v[70000] = -1
    data[70000] = -1
    assert np.array_equal(v.to_numpy(), data)
    assert np.array_equal(np.array(list(v)), data)


@pytest.mark.parametrize("eng", ENGINES)
def test_apply_and_early_stop(eng):
    rng = np.random.default_rng(6)
    data = rng.integers(0, 100, 10000).astype(np.int32)
    v = CompressedArray(np.int32, engine=_engine(eng))
    v.extend(data)

    def double(chunk):
        chunk *= 2

    assert v.apply(double, 100, 5000) == 4900
    data[100:5000] *= 2
    assert np.array_equal(v.to_numpy(), data)
    count = [0]

    def stop_early(chunk):
        count[0] += 1
        return False

    v.apply(stop_early)
    assert count[0] == 1


def test_apply_backward():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 100, 1000).astype(np.int32)
    v = CompressedArray(np.int32, level=1, engine=None)
    v.extend(data)
    seen = []
    v.const_apply_backward(lambda c: seen.extend(c.tolist()))
    assert seen == data[::-1].tolist()
    v.apply_backward(lambda c: c.__iadd__(1))
    assert np.array_equal(v.to_numpy(), data + 1)


@pytest.mark.parametrize("eng", ENGINES)
def test_const_apply_stays_clean(eng):
    rng = np.random.default_rng(8)
    data = np.sort(rng.integers(0, 1 << 30, 4096)).astype(np.int32)
    v = CompressedArray(np.int32, level=1, max_raw_buckets=2,
                        engine=_engine(eng))
    v.extend(data)
    blob1 = v.serialize()
    acc = []
    assert v.const_apply(lambda c: acc.append(int(c.sum()))) == len(v)
    assert sum(acc) == int(data.sum())
    assert not any(b.dirty for b in v._buckets[:-1])
    with pytest.raises((ValueError, RuntimeError)):
        v.const_apply(lambda c: c.__setitem__(0, 1))
    assert v.serialize() == blob1


def test_eviction_bounded():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 1 << 20, 300000).astype(np.int32)
    v = CompressedArray(np.int32, max_raw_buckets=3, engine=None)
    v.extend(data)
    assert v._raw_count <= 4
    for i in rng.integers(0, len(data), 50):
        assert v[int(i)] == data[int(i)]
    assert v._raw_count <= 4


@pytest.mark.parametrize("eng", ENGINES)
def test_eviction_is_lru(eng):
    """Overflow packs the least recently used bucket, not the
    lowest-indexed one."""
    rng = np.random.default_rng(10)
    data = rng.integers(0, 1 << 20, 1024 * 16).astype(np.int32)
    v = CompressedArray(np.int32, block_shift=2, max_raw_buckets=3,
                        engine=_engine(eng))
    v.extend(data)  # 1024-element chunks -> 16 buckets
    assert len(v._buckets) == 16
    _ = v[0]
    _ = v[v.chunk_elems]
    _ = v[2 * v.chunk_elems]
    assert v._buckets[2].raw is not None
    _ = v[3 * v.chunk_elems]  # over the limit: the least recent goes
    assert v._buckets[3].raw is not None
    assert v._buckets[0].raw is None
    for i in rng.integers(0, len(data), 40):
        assert v[int(i)] == data[int(i)]


def test_insert_erase_resize_against_a_list():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 1 << 30, 3000).astype(np.int32)
    v = CompressedArray(np.int32, level=2, engine=None)
    v.extend(data)
    ref = list(data)
    v.insert(100, 7)
    ref.insert(100, 7)
    v.insert(0, [1, 2, 3])
    ref[0:0] = [1, 2, 3]
    v.erase(50)
    del ref[50]
    v.erase(10, 700)
    del ref[10:700]
    v.resize(len(v) - 500)
    del ref[len(ref) - 500:]
    v.resize(len(v) + 123, fill=-5)
    ref += [-5] * 123
    assert v.pop_back() == ref.pop()
    assert np.array_equal(v.to_numpy(), np.array(ref, np.int32))
    v.clear()
    assert len(v) == 0 and v.serialize()[:8] == bytes([255]) + bytes(7)


def test_stream_serialize_and_metrics():
    rng = np.random.default_rng(12)
    data = np.sort(rng.integers(0, 1 << 30, 9000)).astype(np.uint32)
    v, ref = _pair("host", dtype=np.uint32, block_shift=1, level=2)
    v.extend(data)
    ref.extend(data)
    buf = io.BytesIO()
    n = v.serialize_to(buf)
    assert n == buf.tell() and buf.getvalue() == v.serialize()
    assert buf.getvalue() == ref.serialize()
    buf.seek(0)
    w = CompressedArray.deserialize_from(buf, np.uint32, engine=None)
    assert np.array_equal(w.to_numpy(), data)
    assert v.memory_footprint() == ref.memory_footprint() > 0
    assert v.current_compression_ratio() == ref.current_compression_ratio()
    assert v.compression_ratio() == ref.compression_ratio() > 1.0


@pytest.mark.parametrize("eng", ENGINES)
def test_concurrent_fetch_add_stress(eng):
    """16 threads read-modify-write the same container
    (test_cvector.cpp:692-726's fetch_add)."""
    n = 4096 if eng == "cpu" else 8192
    v = CompressedArray(np.int64, level=1, max_raw_buckets=3,
                        engine=_engine(eng))
    v.extend(np.zeros(n, np.int64))
    threads, adds = 16, 4 if eng == "host" else 2

    def worker(seed):
        r = np.random.default_rng(seed)
        for _ in range(adds):
            v.apply(lambda c: c.__iadd__(1))
            for i in r.integers(0, n, 8):
                v[int(i)]

    ts = [threading.Thread(target=worker, args=(s,)) for s in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: lost updates show
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert (v.to_numpy() == threads * adds).all()


# -------------------------------------- tests/test_foreach_threads.py
def _arr(n=5000, seed=0, eng="host"):
    rng = np.random.default_rng(seed)
    a = CompressedArray(np.int32, level=1, engine=_engine(eng))
    vals = rng.integers(0, 1000, n).astype(np.int32)
    a.extend(vals)
    return a, vals


@pytest.mark.parametrize("eng", ENGINES)
def test_for_each_visits_all_and_counts(eng):
    a, vals = _arr(eng=eng)
    seen = []
    assert a.const_for_each(lambda x: seen.append(int(x)) or True) == len(vals)
    assert seen == vals.tolist()


def test_for_each_void_functor_continues():
    a, vals = _arr(n=700)
    seen = []
    assert a.const_for_each(lambda x: seen.append(int(x))) == len(vals)
    assert len(seen) == len(vals)


def test_for_each_early_stop_excludes_failing_element():
    a, _ = _arr()
    box = [0]

    def fn(x):
        if box[0] == 1234:
            return False
        box[0] += 1
        return True

    assert a.const_for_each(fn) == 1234


def test_for_each_range_and_backward():
    a, vals = _arr()
    seen = []
    assert a.const_for_each(lambda x: seen.append(int(x)), start=100,
                            stop=300) == 200
    assert seen == vals[100:300].tolist()
    seen_b = []
    a.const_for_each_backward(lambda x: seen_b.append(int(x)), start=100,
                              stop=300)
    assert seen_b == vals[100:300][::-1].tolist()
    assert a.for_each(lambda x: True, 4990) == 10
    assert a.for_each_backward(lambda x: True, 0, 5) == 5
