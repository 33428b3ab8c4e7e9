"""Device-resident compressed array: the cvector mode whose compressed data
lives in device memory.

Data lives as frame records [1, csize u24, stream] plus the decode index the
index-mode encode emits (ops.encode_kernel.encode_superblocks_index: one
int32 per 256-byte plane, offset | plane code << 24, 1.6% of the raw size);
slabs decode on demand with the derive-mode decode kernel
(ops.decode_kernel.decode_rows_derive), which rebuilds the row records from
the stream's own header bytes. No host byte traffic in either direction;
memory_footprint is the compressed device bytes, access is slab-granular.

With entropy=True the records also pass an entropy stage (_EntropyStore):
they are concatenated into 128 KiB blocks, each Huffman-coded in four
32 KiB streams with decode anchors (entropy.huff_kernel: histogram and
stream-encode kernels, tables on the host), or kept raw where coding does
not pay; reads decode the covering blocks with the anchored decode kernel
(entropy.huff_decode_kernel) before the block decode.

serialize() emits a standard stenos frame (custom-blocksize header,
stenos.h:159-168); deserialize() adopts a frame through the native batched
parser. Counterpart of stenos_tpu/device_container.py.
"""

import numpy as np
import torch

from . import frame as _frame
from .constants import ERROR_INVALID_INPUT
from .engine import TorchEngine, _to_device
from .entropy.huff_decode_kernel import decode_streams, decode_tables
from .entropy.huff_kernel import BLOCK, STREAM, encode_streams, histogram
from .entropy.huffman import luts_batch
from .ops.decode_kernel import decode_rows_derive
from .ops.encode_kernel import encode_superblocks_index, record_bound


def _device(device):
    """The container's device: "cuda" unless the caller asks for another;
    TorchEngine raises when CUDA is asked for and absent."""
    return TorchEngine("cuda" if device is None else device).device


def _bucket125(n: int) -> int:
    """Geometric ~1.25x buckets rounded to 512 (the JAX package's row-width
    rule, kept so that container footprints agree)."""
    b = 4096
    while b < n:
        b = -(-(b + b // 4) // 512) * 512
    return b


def _shift_of(slab_bytes: int, bpp: int) -> int:
    block = 256 * bpp
    shift = 0
    while (block << shift) < slab_bytes:
        shift += 1
    return shift


class DeviceCompressedArray:
    """Immutable-shape device-resident compressed array of a fixed dtype.

    Build with from_array / deserialize; read with slab(i), __getitem__
    (an element decodes its slab; a slice decodes the array) or to_array().
    """

    def __init__(self, dtype, slab_bytes: int, nbytes: int, rows, totals,
                 plane_off, tail: bytes, plane_order: str, device):
        self.dtype = np.dtype(dtype)
        self.slab_bytes = slab_bytes
        self.nbytes = nbytes
        self.device = device
        self._rows = rows            # (n_slabs, rb) uint8 on the device
        self._totals = totals        # (n_slabs,) int32, host numpy
        self._plane_off = plane_off  # (n_slabs, P) int32, off | code << 24
        # plane order of _plane_off: 'jb' (the encoder's) or 'bj' (the
        # parser's, adopted frames)
        self._order = plane_order
        self._tail = tail            # bytes past the last full slab
        # an adopted frame's own records (host bytes): its virtual streams
        # are longer than its records where LZ/COPY blocks were inlined, so
        # serialize() re-emits these
        self._records = None
        # the entropy stage (from_array(entropy=True)); _rows is None then
        self._entropy = None

    # ---------------------------------------------------------- construct
    @classmethod
    def from_array(cls, arr, slab_elems=None, block_level: int = 2,
                   entropy: bool = False, device=None):
        """arr: 1-D array of a fixed-size dtype (numpy, or anything
        np.asarray takes). slab_elems defaults to 128 KiB of elements.

        Slabs hold a power-of-two number nb <= min(128, max(8, 1024 // bpp))
        of 256-element blocks, so that serialize()'s custom-shift frame
        header (slab = block << shift) is exact; the rule fixes the frames and
        records, which stay byte-identical to stenos_tpu's. Rows are cut to
        _bucket125(longest record + 512) bytes, as stenos_tpu cuts them, so
        memory_footprint agrees with stenos_tpu wherever that bucket is below
        both packages' full row widths (record_bound here).

        entropy=True adds the entropy stage (_EntropyStore), kept only where
        it is smaller than the row store it replaces."""
        dev = _device(device)
        a = np.ascontiguousarray(np.asarray(arr)).reshape(-1)
        dtype = a.dtype
        bpp = dtype.itemsize
        cap = min(128, max(8, 1024 // bpp))
        if slab_elems is not None:
            cap = min(slab_elems // 256, cap)
        nb = 1
        while nb * 2 <= cap:
            nb *= 2
        slab_bytes = nb * 256 * bpp
        raw = a.view(np.uint8)
        nbytes = len(raw)
        n_slabs = nbytes // slab_bytes
        tail = raw[n_slabs * slab_bytes:].tobytes()
        if n_slabs == 0:
            return cls(dtype, slab_bytes, nbytes, None,
                       np.zeros(0, np.int32), None, tail, "jb", dev)
        batch = _to_device(raw[: n_slabs * slab_bytes].reshape(
            n_slabs, slab_bytes), dev)
        rows, totals, _, _, po = encode_superblocks_index(
            batch, bpp, block_level, record_bound(nb, bpp))
        totals = totals.cpu().numpy()
        rb = min(_bucket125(int(totals.max()) + 512), rows.shape[1])
        rows = rows[:, :rb].contiguous()  # a copy: frees the full width
        self = cls(dtype, slab_bytes, nbytes, rows, totals, po, tail, "jb",
                   dev)
        if entropy:
            self._entropy = _EntropyStore.pack(rows, totals, rb)
            if self._entropy is not None:
                self._rows = None  # the records live entropy-coded now
        return self

    @classmethod
    def deserialize(cls, frame: bytes, dtype, device=None):
        """Adopt a standard stenos frame (any producer) without decoding it:
        the native parser builds the decode index on the host and the
        records go to the device. A frame whose full superblocks are not all
        method BLOCK is decoded and encoded anew."""
        from .native import load

        dev = _device(device)
        frame = bytes(frame)
        dtype = np.dtype(dtype)
        bpp = dtype.itemsize
        dsize, sb, pos = _frame.get_info(frame, bpp)
        n_full = dsize // sb
        offs, csizes = [], []
        p = pos
        ok = sb % (256 * bpp) == 0
        for _ in range(n_full if ok else 0):
            if p + 4 > len(frame) or frame[p] != 1:
                ok = False
                break
            c = int.from_bytes(frame[p + 1 : p + 4], "little")
            offs.append(p + 4)
            csizes.append(c)
            p += 4 + c
        r = None
        if ok and n_full:
            r = load().parse_rows_batch(frame, bpp, sb, offs, csizes,
                                        _bucket125(max(csizes) + 512))
        if r is None or isinstance(r, int):
            data = _frame.decompress(frame, bpp, engine=TorchEngine(dev))
            return cls.from_array(np.frombuffer(data.tobytes(), dtype),
                                  device=dev)
        vbufs, plane_off, _, vlens = r
        tail = b""
        if dsize > n_full * sb:  # short last superblock: decode it alone
            c = int.from_bytes(frame[p + 1 : p + 4], "little")
            tail = _frame.decompress_superblock(
                frame[p], np.frombuffer(frame, np.uint8)[p + 4 : p + 4 + c],
                bpp, dsize - n_full * sb).tobytes()
            if len(tail) != dsize - n_full * sb:
                raise _frame.StenosError(ERROR_INVALID_INPUT)
        # rows hold the VIRTUAL streams behind each record's own header:
        # offsets become record-relative (+4 in the low 24 bits; bits 24-25
        # carry the plane code)
        fb = np.frombuffer(frame, np.uint8)
        rows = np.zeros((n_full, vbufs.shape[1] + 4), np.uint8)
        rows[:, :4] = fb[np.asarray(offs)[:, None] - 4 + np.arange(4)]
        rows[:, 4:] = vbufs  # the parser zero-fills past each vlen
        po = ((plane_off & 0xFFFFFF) + 4) | (plane_off & ~0xFFFFFF)
        self = cls(dtype, sb, dsize, torch.from_numpy(rows).to(dev),
                   (vlens + 4).astype(np.int32),
                   torch.from_numpy(po.astype(np.int32)).to(dev), tail, "bj",
                   dev)
        self._records = [frame[o - 4 : o + c] for o, c in zip(offs, csizes)]
        return self

    # ------------------------------------------------------------- access
    @property
    def n_slabs(self) -> int:
        return len(self._totals)

    def __len__(self) -> int:
        return self.nbytes // self.dtype.itemsize

    def slab(self, i: int):
        """Slab i decoded: a (slab_bytes,) uint8 tensor on the device."""
        return self._decode_range(i, i + 1).reshape(-1)

    def _decode_range(self, s0: int, s1: int):
        """Slabs [s0, s1) decoded: (s1 - s0, slab_bytes) uint8 on the
        device, one launch of the derive-mode decode kernel."""
        bpp = self.dtype.itemsize
        nb = self.slab_bytes // (256 * bpp)
        rows = (self._rows[s0:s1] if self._entropy is None
                else self._entropy.slab_vbufs(s0, s1))
        return decode_rows_derive(rows, self._plane_off[s0:s1], bpp, nb,
                                  self._order)

    def to_array(self) -> np.ndarray:
        out = np.empty(self.nbytes, np.uint8)
        body = self.n_slabs * self.slab_bytes
        if self.n_slabs:
            out[:body] = self._decode_range(0, self.n_slabs).reshape(
                -1).cpu().numpy()
        out[body:] = np.frombuffer(self._tail, np.uint8)
        return out.view(self.dtype)

    def __getitem__(self, idx):
        n = len(self)
        if isinstance(idx, (int, np.integer)):
            idx = int(idx) + (n if idx < 0 else 0)
            if not 0 <= idx < n:
                raise IndexError(idx)
            esize = self.dtype.itemsize
            b = idx * esize
            s, off = divmod(b, self.slab_bytes)
            if s >= self.n_slabs:
                src = self._tail
            else:
                src = self.slab(s)[off : off + esize].cpu().numpy().tobytes()
                off = 0
            return np.frombuffer(src, self.dtype, count=1, offset=off)[0]
        if isinstance(idx, slice):
            return self.to_array()[idx]
        raise TypeError(idx)

    # ------------------------------------------------------------ metrics
    def memory_footprint(self) -> int:
        """Compressed device bytes + index (cvector.hpp:1886-1895)."""
        if self._entropy is not None:
            return (self._entropy.nbytes() + self._plane_off.numel() * 4
                    + len(self._tail))
        if self._rows is None:
            return len(self._tail)
        return (self._rows.numel() + self._plane_off.numel() * 4
                + len(self._tail))

    def current_compression_ratio(self) -> float:
        return self.nbytes / max(self.memory_footprint(), 1)

    # ------------------------------------------------------ serialization
    def serialize(self) -> bytes:
        """Standard stenos frame with a custom-blocksize header, decodable
        by decompress and by the C++ library."""
        out = [bytes([255]) + self.nbytes.to_bytes(7, "little")
               + self.slab_bytes.to_bytes(4, "little")]
        if self._records is not None:
            out += self._records
        elif self._entropy is not None:
            # the frame carries the block-codec records: the Huffman stage
            # is internal to the container
            out.append(self._entropy.records())
        elif self.n_slabs:
            rows = self._rows.cpu().numpy()
            keep = np.arange(rows.shape[1]) < self._totals[:, None]
            out.append(rows[keep].tobytes())  # row-major: records in order
        if self._tail:
            blob = _frame.compress(
                np.frombuffer(self._tail, np.uint8), self.dtype.itemsize, 1,
                custom_shift=_shift_of(self.slab_bytes, self.dtype.itemsize))
            out.append(blob[12:])  # its superblock record, without header
        return b"".join(out)


def record_blocks(rows, totals, chunk_bytes: int = 1 << 25):
    """The records rows[i, :totals[i]] back to back, then zeros up to whole
    blocks: (nblk, BLOCK) uint8 on the rows' device, the entropy stage's
    input (the last block's zeros count in its histogram).

    One gather per run of rows holding about chunk_bytes of records, at
    record bases from a cumsum of the host totals: each output byte reads
    row * width + (its place - the record's base), int32 within a run, so
    the transient indices take ~12 bytes per record byte of one run, not
    the two int64 per byte of a boolean-mask select over all the rows."""
    dev = rows.device
    n, width = rows.shape
    totals = np.asarray(totals, np.int64)
    ends = np.cumsum(totals)
    body = int(ends[-1]) if n else 0
    nblk = -(-body // BLOCK)
    blocks = torch.zeros(nblk * BLOCK, dtype=torch.uint8, device=dev)
    per = max(1, min(chunk_bytes, (1 << 31) - 1) // max(width, 1))
    for i in range(0, n, per):
        j = min(i + per, n)
        lo = int(ends[i] - totals[i])
        size = int(ends[j - 1]) - lo
        t = torch.from_numpy(totals[i:j].astype(np.int32)).to(dev)
        base = (torch.arange(j - i, dtype=torch.int32, device=dev) * width
                - (torch.cumsum(t, 0, dtype=torch.int32) - t))
        src = (torch.repeat_interleave(base, t, output_size=size)
               + torch.arange(size, dtype=torch.int32, device=dev))
        blocks[lo:lo + size] = rows[i:j].reshape(-1).index_select(0, src)
    return blocks.view(nblk, BLOCK)


class _EntropyStore:
    """The container's entropy stage (stenos_tpu/device_container.py
    _EntropyStore): the slab records, back to back, cut into 128 KiB blocks.
    A block is Huffman-coded, four 32 KiB streams with anchors, iff it uses
    at least 2 symbols and its streams plus ~5.2 KiB of anchors and tables
    come to less than 92% of the block; else it stays raw. Only the coded
    blocks' rows are kept (words cut to wbucket bytes, a multiple of 512),
    and the whole stage is dropped unless it is smaller than the row
    store. A read decodes the 1-2 blocks covering its slabs' records."""

    def __init__(self, words, sizes, anchors, tabs, flags, raw, offs, totals,
                 rb):
        self.words = words      # (ncoded*4, wbucket/4) int32, device
        self.sizes = sizes      # (ncoded*4,) int32, host
        self.anchors = anchors  # (ncoded*4, 256) int32, device
        self.tabs = tabs        # (ncoded*4, 304) int32, device
        self.flags = flags      # (nblk,) bool, host: True = Huffman-coded
        self.raw = raw          # (nraw, BLOCK) uint8, device: raw blocks
        self.offs = offs        # (n_slabs,) int64, host: record offsets
        self.totals = totals    # (n_slabs,) host: record lengths
        self.rb = rb            # row width of the reassembled records
        # block -> its row group among the coded rows, or among the raw ones
        self._slot = np.where(flags, np.cumsum(flags), np.cumsum(~flags)) - 1

    @classmethod
    def pack(cls, rows, totals, rb):
        """The store for rows (n_slabs, rb) uint8 holding totals[i] record
        bytes each, or None when it would not be smaller than the rows."""
        dev = rows.device
        totals = np.asarray(totals, np.int64)
        offs = np.cumsum(totals) - totals
        blocks = record_blocks(rows, totals)
        nblk = blocks.shape[0]
        if nblk == 0:
            return None
        lens, luts = luts_batch(histogram(blocks).cpu().numpy())
        words, sizes, anchors = encode_streams(
            blocks.view(nblk * 4, STREAM),
            torch.from_numpy(np.repeat(luts, 4, axis=0)).to(dev),
            with_anchors=True)
        sizes = sizes.cpu().numpy()
        flags = (((lens > 0).sum(axis=1) >= 2)
                 & (sizes.reshape(nblk, 4).sum(axis=1) + 5200
                    < BLOCK * 92 // 100))
        if not flags.any():
            return None
        coded = np.flatnonzero(flags)
        ridx = (coded[:, None] * 4 + np.arange(4)).reshape(-1)
        wbucket = -(-int(sizes[ridx].max()) // 512) * 512
        ridx_t = torch.from_numpy(ridx).to(dev)
        store = cls(words[ridx_t, :wbucket // 4].contiguous(), sizes[ridx],
                    anchors[ridx_t],
                    torch.from_numpy(np.repeat(decode_tables(lens[coded]), 4,
                                               axis=0)).to(dev),
                    flags, blocks[torch.from_numpy(~flags).to(dev)],
                    offs, totals, rb)
        if store.nbytes() >= rows.shape[0] * rows.shape[1]:
            return None
        return store

    def nbytes(self) -> int:
        """Device bytes of the stage: coded words, anchors, tables and the
        raw blocks."""
        return (self.words.numel() * 4 + self.anchors.numel() * 4
                + self.tabs.numel() * 4 + self.raw.numel())

    def decode_blocks(self, b0: int, b1: int):
        """Blocks [b0, b1) decoded: ((b1 - b0) * BLOCK + rb,) uint8 on the
        device (rb zero bytes of slack at the end), one launch of the
        anchored decode kernel for the coded ones."""
        dev = self.words.device
        flags = torch.from_numpy(self.flags[b0:b1]).to(dev)
        slot = torch.from_numpy(self._slot[b0:b1]).to(dev)
        flat = torch.empty((b1 - b0) * BLOCK + self.rb, dtype=torch.uint8,
                           device=dev)
        flat[(b1 - b0) * BLOCK:] = 0
        out = flat[:(b1 - b0) * BLOCK].view(b1 - b0, BLOCK)
        if self.flags[b0:b1].any():
            rows = (slot[flags][:, None] * 4
                    + torch.arange(4, device=dev)).reshape(-1)
            syms = decode_streams(self.words[rows].view(torch.uint8),
                                  self.anchors[rows], self.tabs[rows])
            out[flags] = syms.view(-1, BLOCK)
        if not self.flags[b0:b1].all():
            out[~flags] = self.raw[slot[~flags]]
        return flat

    def slab_vbufs(self, s0: int, s1: int):
        """The records of slabs [s0, s1) as (s1 - s0, rb) uint8 rows: row i
        is the rb bytes from record s0 + i's start, so it runs on into the
        next records, as stenos_tpu's windows do (the decode reads only
        where the index points)."""
        lo = int(self.offs[s0])
        hi = int(self.offs[s1 - 1] + self.totals[s1 - 1])
        b0, b1 = lo // BLOCK, -(-hi // BLOCK)
        flat = self.decode_blocks(b0, b1)
        start = torch.from_numpy(self.offs[s0:s1] - b0 * BLOCK).to(flat.device)
        # one gather of rows of the (overlapping) window view
        return flat.unfold(0, self.rb, 1)[start]

    def records(self) -> bytes:
        """All the records, back to back (one decode of every block)."""
        flat = self.decode_blocks(0, len(self.flags))
        return flat[: int(self.totals.sum())].cpu().numpy().tobytes()
