"""CompressedArray, the cvector equivalent (reference: stenos/cvector.hpp),
ported from stenos_tpu/container.py.

A chunked, transparently-compressed array: data lives as independently
compressed buckets of 256<<block_shift elements; a bounded pool of
decompressed buckets (with dirty tracking) serves reads/writes, mirroring
the reference's CompressedVectorInternal context stealing
(cvector.hpp:1340-1927) with Python/numpy-shaped APIs (slicing and bulk
`apply` instead of C++ reference wrappers).

Each bucket is one superblock record: with a TorchEngine (on "cuda" unless
the caller asks for another device or for engine=None, the numpy host path)
a bucket encodes with one launch of the encode kernel and decodes with one
launch of the decode kernel (frame.compress_superblock,
frame.decompress_superblock).

Serialization is byte-compatible with cvector::serialize: a custom-blocksize
stenos frame (shift=255 header, stenos.cpp:829-842) whose payload is
decompressible by plain stenos_decompress, and byte-identical to the JAX
package's container after the same calls (tests/test_torch_container.py).
"""

import collections
import threading

import numpy as np

from . import frame as _frame
from .constants import compress_bound
from .engine import DEFAULT, resolve


class _Bucket:
    __slots__ = ("compressed", "raw", "dirty")

    def __init__(self):
        self.compressed = None  # bytes: 4B superblock header + payload
        self.raw = None  # np array of elements (decompressed)
        self.dirty = False


class CompressedArray:
    """A compressed, append-able 1-D array of fixed-size elements.

    Thread-safety contract (the cvector analog of SharedSpinner +
    per-bucket locks, cvector.hpp:328-406): every public method takes the
    container lock, so concurrent reads, writes, `apply` calls and appends
    from multiple threads are safe (verified by the 16-thread fetch_add
    stress in tests/test_torch_container.py, mirroring
    test_cvector.cpp:692-726).
    A coarse reentrant lock is the idiomatic Python equivalent — bucket
    decompression/eviction mutates shared pool state on *reads*, exactly
    the hazard the reference's reader locks guard against.
    """

    def __init__(self, dtype, block_shift: int = 0, level: int = 1,
                 engine=DEFAULT, max_raw_buckets: int | None = None,
                 device=None):
        self.dtype = np.dtype(dtype)
        if self.dtype.hasobject:
            raise TypeError("CompressedArray requires a fixed-size dtype")
        self.block_shift = block_shift
        self.level = level
        self.engine = resolve(engine, device)
        self.chunk_elems = 256 << block_shift
        self.chunk_bytes = self.chunk_elems * self.dtype.itemsize
        self._buckets: list[_Bucket] = []
        self._size = 0  # total elements
        self._max_raw = max_raw_buckets
        self._raw_count = 0
        # residency order for eviction: id(bucket) -> bucket, oldest first
        # (the cvector free-context-list analog, cvector.hpp:1700-1800 —
        # O(1) per eviction instead of a front rescan of every bucket)
        self._lru: "collections.OrderedDict[int, _Bucket]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()

    # ------------------------------------------------------------- internals
    def _bpp(self) -> int:
        return self.dtype.itemsize

    def _compress_chunk(self, raw_bytes: np.ndarray) -> bytes:
        rec = _frame.compress_superblock(
            raw_bytes, self._bpp(), self.level,
            compress_bound(len(raw_bytes)) + 16, self.engine)
        if _frame.strong_debug():
            # cvector debug builds round-trip verify every chunk compression
            # (cvector.hpp:1396-1407)
            back = _frame.decompress_superblock(
                rec[0], np.frombuffer(rec, np.uint8)[4:], self._bpp(),
                len(raw_bytes), self.engine)
            if bytes(memoryview(np.asarray(back))) != raw_bytes.tobytes():
                raise AssertionError(
                    "STENOS_STRONG_DEBUG: chunk round-trip mismatch")
        return rec

    def _decompress_chunk(self, blob: bytes, nbytes: int) -> np.ndarray:
        code = blob[0]
        return _frame.decompress_superblock(
            code, np.frombuffer(blob, np.uint8)[4:], self._bpp(), nbytes,
            self.engine)

    def _bucket_len(self, i: int) -> int:
        if i < len(self._buckets) - 1:
            return self.chunk_elems
        return self._size - i * self.chunk_elems

    def _raw(self, i: int) -> np.ndarray:
        """Decompress bucket i into its raw cache (stealing if over limit)."""
        b = self._buckets[i]
        if b.raw is None:
            nbytes = self._bucket_len(i) * self.dtype.itemsize
            data = self._decompress_chunk(b.compressed, nbytes)
            b.raw = np.asarray(data).view(self.dtype).copy()
            self._raw_count += 1
            self._lru[id(b)] = b
            self._evict(keep=b)
        else:
            lru = self._lru
            if id(b) in lru:
                lru.move_to_end(id(b))
        return b.raw

    def _evict(self, keep: _Bucket):
        limit = self._max_raw or max(2, len(self._buckets) // 16 + 1)
        if self._raw_count <= limit:
            return
        back = self._buckets[-1] if self._buckets else None
        for key in list(self._lru):  # oldest resident first
            b = self._lru[key]
            if b.raw is None:  # stale entry: packed or dropped elsewhere
                del self._lru[key]
                continue
            if b is keep or b is back:  # keep the back bucket hot
                continue
            self._pack(b)
            if self._raw_count <= limit:
                return

    def _pack(self, b) -> None:
        if isinstance(b, int):
            b = self._buckets[b]
        if b.raw is None:
            return
        if b.dirty or b.compressed is None:
            raw_bytes = np.frombuffer(b.raw.tobytes(), np.uint8)
            b.compressed = self._compress_chunk(raw_bytes)
            b.dirty = False
        b.raw = None
        self._raw_count -= 1
        self._lru.pop(id(b), None)

    def _back_raw(self, i: int) -> np.ndarray:
        """Raw storage of bucket i grown to full chunk capacity (append
        path); assumes the lock is held."""
        b = self._buckets[i]
        if b.raw is None:
            self._raw(i)
            b = self._buckets[i]
        if len(b.raw) < self.chunk_elems:
            full = np.empty(self.chunk_elems, self.dtype)
            full[: len(b.raw)] = b.raw
            b.raw = full
        return b.raw

    def _new_back_bucket(self) -> _Bucket:
        nb = _Bucket()
        nb.raw = np.empty(self.chunk_elems, self.dtype)
        self._buckets.append(nb)
        self._raw_count += 1
        self._lru[id(nb)] = nb
        self._evict(keep=nb)
        return nb

    # ------------------------------------------------------------- basic API
    def __len__(self) -> int:
        return self._size

    def append(self, value):
        with self._lock:
            i = self._size // self.chunk_elems
            if i == len(self._buckets):
                self._new_back_bucket()
            raw = self._back_raw(i)
            raw[self._size % self.chunk_elems] = value
            self._buckets[i].dirty = True
            self._size += 1

    push_back = append  # cvector::push_back spelling

    def pop_back(self):
        """Remove and return the last element (cvector::pop_back)."""
        with self._lock:
            if not self._size:
                raise IndexError("pop from empty CompressedArray")
            v = self[self._size - 1]
            self._size -= 1
            if self._size <= (len(self._buckets) - 1) * self.chunk_elems:
                b = self._buckets.pop()
                if b.raw is not None:
                    self._raw_count -= 1
                    self._lru.pop(id(b), None)
            else:
                self._buckets[-1].dirty = True
            return v

    def extend(self, values):
        values = np.asarray(values, self.dtype)
        with self._lock:
            pos = 0
            while pos < len(values):
                i = self._size // self.chunk_elems
                off = self._size % self.chunk_elems
                if i == len(self._buckets):
                    self._new_back_bucket()
                raw = self._back_raw(i)
                take = min(self.chunk_elems - off, len(values) - pos)
                raw[off : off + take] = values[pos : pos + take]
                self._buckets[i].dirty = True
                self._size += take
                pos += take

    def __getitem__(self, idx):
        with self._lock:
            if isinstance(idx, slice):
                start, stop, step = idx.indices(self._size)
                out = np.empty(max(0, -(-(stop - start) // step)) if step > 0
                               else max(0, -(-(start - stop) // -step)),
                               self.dtype)
                # bulk path over touched buckets
                r = np.arange(start, stop, step)
                for i in np.unique(r // self.chunk_elems):
                    sel = (r // self.chunk_elems) == i
                    local = r[sel] - i * self.chunk_elems
                    out[np.nonzero(sel)[0]] = self._raw(int(i))[local]
                return out
            idx = int(idx)
            if idx < 0:
                idx += self._size
            if not 0 <= idx < self._size:
                raise IndexError(idx)
            return self._raw(idx // self.chunk_elems)[idx % self.chunk_elems]

    at = __getitem__  # cvector::at spelling

    def __setitem__(self, idx, value):
        with self._lock:
            if isinstance(idx, slice):
                start, stop, step = idx.indices(self._size)
                r = np.arange(start, stop, step)
                value = np.broadcast_to(np.asarray(value, self.dtype),
                                        r.shape)
                for i in np.unique(r // self.chunk_elems):
                    sel = (r // self.chunk_elems) == i
                    local = r[sel] - i * self.chunk_elems
                    raw = self._raw(int(i))
                    raw[local] = value[np.nonzero(sel)[0]]
                    self._buckets[int(i)].dirty = True
                return
            idx = int(idx)
            if idx < 0:
                idx += self._size
            if not 0 <= idx < self._size:
                raise IndexError(idx)
            i = idx // self.chunk_elems
            self._raw(i)[idx % self.chunk_elems] = value
            self._buckets[i].dirty = True

    def __iter__(self):
        nb = len(self._buckets)
        for i in range(nb):
            with self._lock:
                if i >= len(self._buckets):
                    return
                raw = self._raw(i)[: self._bucket_len(i)].copy()
            yield from raw

    # ---------------------------------------------------- structural edits
    def _rebuild_from(self, first: int, chunks):
        """Replace buckets[first:] with the element stream `chunks`
        (iterable of arrays), compressing each completed chunk immediately
        — bounded memory, O(N) from the edit point (the memmove analog of
        cvector insert/erase). Assumes the lock is held."""
        for b in self._buckets[first:]:
            if b.raw is not None:
                self._raw_count -= 1
                self._lru.pop(id(b), None)
        del self._buckets[first:]
        self._size = first * self.chunk_elems
        pend = np.empty(0, self.dtype)
        for c in chunks:
            c = np.asarray(c, self.dtype)
            pend = np.concatenate([pend, c]) if len(pend) else c
            while len(pend) >= self.chunk_elems:
                self.extend(pend[: self.chunk_elems])
                self._pack(len(self._buckets) - 1)
                pend = pend[self.chunk_elems :]
        if len(pend):
            self.extend(pend)

    def _tail_chunks(self, from_elem: int):
        """Yield the element stream [from_elem, size), decompressing each
        bucket at most once; materialized eagerly for buckets that are about
        to be dropped by a rebuild."""
        out = []
        i0 = from_elem // self.chunk_elems
        for i in range(i0, len(self._buckets)):
            lo = max(from_elem - i * self.chunk_elems, 0)
            b = self._buckets[i]
            out.append(self._raw(i)[lo : self._bucket_len(i)].copy())
            if b.raw is not None and not b.dirty and b.compressed is not None:
                b.raw = None  # bucket is about to be dropped: free eagerly
                self._raw_count -= 1
                self._lru.pop(id(b), None)
        return out

    def insert(self, pos: int, values):
        """Insert value(s) before element pos (cvector::insert semantics:
        O(distance-to-end) element moves, chunk-streamed)."""
        values = np.atleast_1d(np.asarray(values, self.dtype))
        with self._lock:
            if pos < 0:
                pos += self._size
            if not 0 <= pos <= self._size:
                raise IndexError(pos)
            i = pos // self.chunk_elems
            off = pos - i * self.chunk_elems
            head = self._raw(i)[:off].copy() if i < len(self._buckets) \
                else np.empty(0, self.dtype)
            tail = self._tail_chunks(pos)
            self._rebuild_from(i, [head, values] + tail)

    def erase(self, start: int, stop: int | None = None):
        """Remove elements [start, stop) (cvector::erase). stop=None
        removes a single element."""
        with self._lock:
            if start < 0:
                start += self._size
            stop = start + 1 if stop is None else min(stop, self._size)
            if not 0 <= start <= self._size or stop < start:
                raise IndexError((start, stop))
            i = start // self.chunk_elems
            off = start - i * self.chunk_elems
            head = self._raw(i)[:off].copy() if i < len(self._buckets) \
                else np.empty(0, self.dtype)
            tail = self._tail_chunks(stop)
            self._rebuild_from(i, [head] + tail)

    def resize(self, n: int, fill=0):
        """Grow with `fill` or shrink to n elements (cvector::resize)."""
        with self._lock:
            if n >= self._size:
                grow = n - self._size
                if grow:
                    self.extend(np.full(grow, fill, self.dtype))
                return
            keep = -(-n // self.chunk_elems) if n else 0
            if keep and n < keep * self.chunk_elems:
                # last kept bucket becomes partial: materialize it BEFORE
                # truncating _size (decompression needs the full length),
                # and dirty it so eviction re-compresses the short chunk
                self._raw(keep - 1)
                self._buckets[keep - 1].dirty = True
            self._size = n
            for b in self._buckets[keep:]:
                if b.raw is not None:
                    self._raw_count -= 1
                    self._lru.pop(id(b), None)
            del self._buckets[keep:]

    def clear(self):
        with self._lock:
            self._buckets.clear()
            self._lru.clear()
            self._size = 0
            self._raw_count = 0

    # ------------------------------------------------------- bulk operations
    def _apply(self, fn, start, stop, mutate: bool, backward: bool):
        # each span is computed UNDER the lock just before it is visited, so
        # concurrent erase/resize between chunks shrinks the scan instead of
        # racing it (buckets appended mid-scan are intentionally not visited:
        # the limit is pinned at entry, matching cvector's for_each contract)
        with self._lock:
            limit = self._size if stop is None else min(stop, self._size)
        visited = 0
        # remaining range is [pos, pos_end); one bucket per iteration
        pos, pos_end = start, limit
        while pos < pos_end:
            i = (pos_end - 1 if backward else pos) // self.chunk_elems
            with self._lock:
                cur = self._size if stop is None else min(stop, self._size)
                pos_end = min(pos_end, cur)
                if pos >= pos_end or i >= len(self._buckets):
                    i = (pos_end - 1 if backward else pos) // self.chunk_elems
                    if pos >= pos_end or i >= len(self._buckets):
                        break
                base = i * self.chunk_elems
                off = max(pos - base, 0)
                end = min(pos_end - base, self._bucket_len(i))
                if end <= off:
                    break
                view = self._raw(i)[off:end]
                if not mutate:
                    view.setflags(write=False)
                r = fn(view[::-1] if backward else view)
                if mutate:
                    self._buckets[i].dirty = True
                else:
                    view.setflags(write=True)
            visited += end - off
            if r is False:
                break
            if backward:
                pos_end = base
            else:
                pos = base + self.chunk_elems
        return visited

    def apply(self, fn, start: int = 0, stop: int | None = None):
        """for_each equivalent (cvector.hpp:2283-2312): run fn(chunk_view)
        over decompressed chunks in [start, stop); fn may mutate the view
        (marks the bucket dirty). Returns the number of elements visited
        (early stop: fn returns False). Read-only scans should use
        const_apply, which does NOT dirty the bucket (no recompression on
        eviction)."""
        return self._apply(fn, start, stop, mutate=True, backward=False)

    def const_apply(self, fn, start: int = 0, stop: int | None = None):
        """const_for_each equivalent: fn receives a read-only view; the
        bucket stays clean, so eviction reuses the existing compressed
        bytes (cvector.hpp const_for_each, :2252-2281)."""
        return self._apply(fn, start, stop, mutate=False, backward=False)

    def apply_backward(self, fn, start: int = 0, stop: int | None = None):
        """for_each_backward: chunks visited in reverse order, each view
        reversed (cvector const_for_each_backward analog, mutable)."""
        return self._apply(fn, start, stop, mutate=True, backward=True)

    def const_apply_backward(self, fn, start: int = 0,
                             stop: int | None = None):
        return self._apply(fn, start, stop, mutate=False, backward=True)

    # element-wise for_each family: the exact reference contract
    # (cvector.hpp:2283-2312): fn receives ONE element; a falsy return stops
    # the scan; the return value counts elements for which fn returned
    # truthy (the failing element is NOT counted). The chunk-wise apply()
    # above is the fast path; these are the parity API.
    def _for_each(self, fn, start, stop, mutate, backward):
        count = 0
        stopped = False

        def chunk(view):
            nonlocal count, stopped
            for x in view:
                # a void visitor (returns None) always continues — the
                # reference's eval_functor void-vs-bool dispatch
                if fn(x) is False:
                    stopped = True
                    return False
                count += 1
            return True

        self._apply(chunk, start, stop, mutate=mutate, backward=backward)
        return count

    def for_each(self, fn, start: int = 0, stop: int | None = None):
        """cvector.hpp:2283-2312 for_each: fn(element) over [start, stop);
        returns the number of elements fn accepted before (exclusive) the
        first falsy return. Elements are numpy scalars; to mutate, use
        apply() with a chunk view (per-element mutation through a scalar
        copy cannot write back)."""
        return self._for_each(fn, start, stop, mutate=True, backward=False)

    def const_for_each(self, fn, start: int = 0, stop: int | None = None):
        return self._for_each(fn, start, stop, mutate=False, backward=False)

    def for_each_backward(self, fn, start: int = 0, stop: int | None = None):
        return self._for_each(fn, start, stop, mutate=True, backward=True)

    def const_for_each_backward(self, fn, start: int = 0,
                                stop: int | None = None):
        return self._for_each(fn, start, stop, mutate=False, backward=True)

    def to_numpy(self) -> np.ndarray:
        with self._lock:
            out = np.empty(self._size, self.dtype)
            pos = 0
            for i in range(len(self._buckets)):
                n = self._bucket_len(i)
                out[pos : pos + n] = self._raw(i)[:n]
                pos += n
            return out

    # ------------------------------------------------------------- metrics
    def memory_footprint(self) -> int:
        total = 0
        for b in self._buckets:
            if b.compressed is not None:
                total += len(b.compressed)
            if b.raw is not None:
                total += b.raw.nbytes
        return total

    def current_compression_ratio(self) -> float:
        fp = self.memory_footprint()
        return (self._size * self.dtype.itemsize) / fp if fp else 0.0

    def compression_ratio(self) -> float:
        comp = sum(len(b.compressed) for b in self._buckets
                   if b.compressed is not None)
        full = sum(self.chunk_bytes for b in self._buckets
                   if b.compressed is not None)
        return full / comp if comp else 0.0

    # --------------------------------------------------------- serialization
    def _serialized_records(self):
        """Yield the frame header then each bucket record (lock held by
        caller per chunk); stragglers compressed on the fly
        (cvector.hpp:3034-3093)."""
        nbytes = self._size * self.dtype.itemsize
        yield bytes([255]) + nbytes.to_bytes(7, "little") + \
            self.chunk_bytes.to_bytes(4, "little")
        for i in range(len(self._buckets)):
            with self._lock:
                b = self._buckets[i]
                n = self._bucket_len(i) * self.dtype.itemsize
                if b.dirty or b.compressed is None or (
                        i == len(self._buckets) - 1 and n < self.chunk_bytes):
                    raw = self._raw(i)[: self._bucket_len(i)]
                    rec = self._compress_chunk(
                        np.frombuffer(raw.tobytes(), np.uint8))
                else:
                    rec = b.compressed
            yield rec

    def serialize(self) -> bytes:
        """cvector::serialize-compatible frame (decompressible by plain
        stenos_decompress / stenos_tpu_torch.decompress)."""
        return b"".join(self._serialized_records())

    def serialize_to(self, stream) -> int:
        """Stream variant (cvector.hpp:3243+): write the frame to a
        file-like object without materializing it; returns bytes written."""
        total = 0
        for rec in self._serialized_records():
            stream.write(rec)
            total += len(rec)
        return total

    @classmethod
    def deserialize(cls, blob: bytes, dtype, level: int = 1, engine=DEFAULT,
                    device=None):
        """Adopt compressed buckets without decompressing (tail excepted),
        cvector.hpp:3134-3187 semantics."""
        dtype = np.dtype(dtype)
        dsize, sb, hlen = _frame.get_info(blob, dtype.itemsize)
        if sb % (256 * dtype.itemsize):
            raise ValueError("superblock size not a chunk multiple")
        shift = (sb // (256 * dtype.itemsize)).bit_length() - 1
        out = cls(dtype, block_shift=shift, level=level, engine=engine,
                  device=device)
        out._size = dsize // dtype.itemsize
        pos = hlen
        nbuckets = -(-dsize // sb) if dsize else 0
        for i in range(nbuckets):
            csize = int.from_bytes(blob[pos + 1 : pos + 4], "little")
            b = _Bucket()
            b.compressed = bytes(blob[pos : pos + 4 + csize])
            out._buckets.append(b)
            pos += 4 + csize
        return out

    @classmethod
    def deserialize_from(cls, stream, dtype, level: int = 1, engine=DEFAULT,
                         device=None):
        """Stream variant (cvector.hpp:3301+): read a serialized frame from
        a file-like object, adopting compressed buckets record by record."""
        dtype = np.dtype(dtype)
        head = stream.read(12)
        if len(head) < 12 or head[0] != 255:
            raise ValueError("not a custom-blocksize stenos frame")
        dsize = int.from_bytes(head[1:8], "little")
        sb = int.from_bytes(head[8:12], "little")
        if sb % (256 * dtype.itemsize):
            raise ValueError("superblock size not a chunk multiple")
        shift = (sb // (256 * dtype.itemsize)).bit_length() - 1
        out = cls(dtype, block_shift=shift, level=level, engine=engine,
                  device=device)
        out._size = dsize // dtype.itemsize
        nbuckets = -(-dsize // sb) if dsize else 0
        for i in range(nbuckets):
            hdr = stream.read(4)
            if len(hdr) < 4:
                raise ValueError("truncated frame record")
            csize = int.from_bytes(hdr[1:4], "little")
            payload = stream.read(csize)
            if len(payload) < csize:
                raise ValueError("truncated frame payload")
            b = _Bucket()
            b.compressed = hdr + payload
            out._buckets.append(b)
        return out
