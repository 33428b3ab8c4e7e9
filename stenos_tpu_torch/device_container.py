"""Device-resident compressed array: the cvector mode whose compressed data
lives in device memory.

Data lives as frame records [1, csize u24, stream] plus the decode index the
index-mode encode emits (ops.encode_kernel.encode_superblocks_index: one
int32 per 256-byte plane, offset | plane code << 24, 1.6% of the raw size);
slabs decode on demand with the derive-mode decode kernel
(ops.decode_kernel.decode_rows_derive), which rebuilds the row records from
the stream's own header bytes. No host byte traffic in either direction;
memory_footprint is the compressed device bytes, access is slab-granular.

serialize() emits a standard stenos frame (custom-blocksize header,
stenos.h:159-168); deserialize() adopts a frame through the native batched
parser. Counterpart of stenos_tpu/device_container.py, without its entropy
stage (entropy=True raises: the Huffman kernels it needs come in a later
slice of the port).
"""

import numpy as np
import torch

from . import frame as _frame
from .constants import ERROR_INVALID_INPUT
from .engine import TorchEngine, _to_device
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
        both packages' full row widths (record_bound here)."""
        if entropy:
            raise NotImplementedError(
                "DeviceCompressedArray(entropy=True) needs the Huffman "
                "kernels (histogram, stream encode, anchored decode), which "
                "a later slice of the port brings")
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
        return cls(dtype, slab_bytes, nbytes, rows, totals, po, tail, "jb",
                   dev)

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
        return decode_rows_derive(self._rows[s0:s1],
                                  self._plane_off[s0:s1], bpp, nb,
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
