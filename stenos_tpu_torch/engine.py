"""Torch engine: the block codec's device work on a CUDA card (or, when the
caller asks for it, on the CPU through the kernels' plain versions).

The frame layer (frame.py) keeps method selection and the host stages; the
engine supplies the block streams and decodes them:

  encode  encode_batch -> ops.encode_kernel.encode_superblocks (the
          encode_blocks kernel) over 64 MiB rounds of full superblocks, then
          per superblock the host LZ patch-up (_patch_lz) and the abort and
          budget checks (finish_block_stream).
  decode  decompress_frame_batched -> native parse_rows_batch over 64 MiB
          chunks -> ops.decode_kernel.decode_rows (the decode_rows kernel);
          frames that are not all method BLOCK decode their BLOCK
          superblocks one by one through decode_block_stream, which launches
          the same kernel (their zstd superblocks go to
          entropy.device_decode, 64 MiB a call: frame.decompress).

and two device-resident paths with no host byte traffic:

  roundtrip_device       encode_superblocks_index (records + decode index)
                         -> decode_rows_derive on the records themselves.
  compress_frame_device  encode_superblocks_frame: the same kernel writes
                         the records, a second launch moves them behind the
                         frame header, in one buffer.

Counterpart of stenos_tpu/engine_jax.py (JaxEngine, decompress_frame_batched,
roundtrip_device, compress_frame_device_jit).
A device that is asked for and missing, a kernel that does not build or
launch, and a native runtime that does not build all raise: nothing here
falls back to a slower tier.
"""

import numpy as np
import torch

from .codec.encode_np import encode_partial
from .codec.lz_np import fresh_table, lz_compress_block
from .constants import (BLOCK_LZ, BLOCK_PARTIAL, ERROR_DST_OVERFLOW,
                        ERROR_INVALID_INPUT)
from .ops.decode_kernel import decode_rows, decode_rows_derive
from .ops.encode_kernel import (encode_superblocks, encode_superblocks_frame,
                                encode_superblocks_index, record_bound)

CHUNK_BYTES = 64 * 1024 * 1024  # superblocks per device call, in bytes


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    # torch.from_numpy wants a writable array; frame bytes are read-only
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


class TorchEngine:
    """Engine adapter for frame.py: device compute + host patch-up."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchEngine: CUDA is not available "
                                   "(pass device='cpu' to run the plain "
                                   "versions on the CPU)")
        elif self.device.type != "cpu":
            raise ValueError(f"TorchEngine: unsupported device {device}")

    def _encode_rounds(self, batch: np.ndarray, bpp: int, block_level: int):
        """One device call over a (r, sb) batch -> per-superblock
        (stream, total, bsizes, fsizes) tuples on the host."""
        x = _to_device(batch, self.device)
        streams, totals, bsizes, fsizes = encode_superblocks(
            x, bpp, block_level)
        streams = streams.cpu().numpy()
        totals = totals.cpu().numpy()
        bsizes = bsizes.cpu().numpy()
        fsizes = fsizes.cpu().numpy()
        return [(streams[i], int(totals[i]), bsizes[i], fsizes[i])
                for i in range(batch.shape[0])]

    def encode_batch(self, data: np.ndarray, bpp: int, sb: int,
                     block_level: int = 2):
        """Encode every full superblock in rounds of CHUNK_BYTES; returns
        per-superblock precomputed results for finish_block_stream (None for
        the partial tail, which takes the per-chunk path)."""
        nbytes = len(data)
        n_sb = -(-nbytes // sb)
        n_full = nbytes // sb
        if n_full == 0 or sb % (256 * bpp):
            return [None] * n_sb
        per_call = max(1, CHUNK_BYTES // sb)
        pre = []
        for i in range(0, n_full, per_call):
            r = min(per_call, n_full - i)
            batch = np.asarray(data[i * sb : (i + r) * sb]).reshape(r, sb)
            pre += self._encode_rounds(batch, bpp, block_level)
        return pre + [None] * (n_sb - n_full)

    def finish_block_stream(self, pre, chunk, bpp, budget, target_ratio,
                            block_level: int = 2, lz_table=None):
        """Host patch-up (LZ splice, abort/budget checks) of a precomputed
        device-encoded full superblock."""
        if pre is None:
            return self.encode_block_stream(chunk, bpp, budget, target_ratio,
                                            block_level, lz_table=lz_table)
        stream, total, bsizes, fsizes = pre
        nbytes = len(chunk)
        block_size = 256 * bpp
        nb = nbytes // block_size
        body = self._patch_lz(stream[:total], chunk, bpp, nb, bsizes, fsizes,
                              block_level, lz_table=lz_table)
        if target_ratio is not None:
            ends = np.cumsum(self._sizes_after_lz)
            cp = (nbytes // 16 + block_size - 1) // block_size - 1
            cp = max(cp, 0)
            if cp < nb and ((cp + 1) * block_size) / ends[cp] < target_ratio:
                return ERROR_DST_OVERFLOW
        if len(body) + 16 > budget or len(body) > budget:
            return ERROR_DST_OVERFLOW
        return body

    def encode_block_stream(self, chunk: np.ndarray, bpp: int, budget: int,
                            target_ratio=None, block_level: int = 2,
                            lz_table=None):
        nbytes = len(chunk)
        if nbytes == 0:
            return b""
        block_size = 256 * bpp
        nb = nbytes // block_size
        body = b""
        if nb:
            full = np.asarray(chunk[: nb * block_size]).reshape(1, -1)
            (out, total, bsizes, fsizes), = self._encode_rounds(
                full, bpp, block_level)
            body = self._patch_lz(out[:total], chunk, bpp, nb, bsizes, fsizes,
                                  block_level, lz_table=lz_table)
            if target_ratio is not None:
                # abort check (block_compress.h:1267-1274) on the (possibly
                # LZ-patched) sizes
                ends = np.cumsum(self._sizes_after_lz)
                cp = None
                for i in range(nb):
                    if (i + 1) * block_size >= nbytes // 16:
                        cp = i
                        break
                if cp is not None:
                    if ((cp + 1) * block_size) / ends[cp] < target_ratio:
                        return ERROR_DST_OVERFLOW
            if len(body) + 16 > budget:
                return ERROR_DST_OVERFLOW

        rem = nbytes - nb * block_size
        if rem:
            tail = encode_partial(np.asarray(chunk[nb * block_size:]), bpp)
            if len(body) + 1 + len(tail) + 8 > budget:
                return ERROR_DST_OVERFLOW
            body = body + bytes([BLOCK_PARTIAL]) + tail
        if len(body) > budget:
            return ERROR_DST_OVERFLOW
        return body

    def _patch_lz(self, stream, chunk, bpp, nb, bsizes, fsizes, block_level,
                  lz_table=None):
        """Host-side intra-block LZ attempts + splice (rare path)."""
        self._sizes_after_lz = bsizes.copy()
        if not (block_level == 2 and bpp % 4 == 0):
            return bytes(stream)
        block_size = 256 * bpp
        cand = np.nonzero(fsizes * 3 > block_size)[0]
        if not len(cand):
            return bytes(stream)
        budget = len(chunk)
        starts = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(bsizes, out=starts[1:])
        pieces = []
        pos = 0
        shrink = 0
        chunk = np.asarray(chunk)
        # the hash table persists across this superblock's LZ attempts
        # (the reference's per-iteration stack slot, block_compress.h:1211);
        # at level 1 the caller passes a FRAME-scoped table instead
        if lz_table is None:
            lz_table = fresh_table()
        for i in cand:
            p = starts[i] - shrink
            if budget > p + fsizes[i] + bpp * 8 + 2:
                payload = lz_compress_block(
                    chunk[i * block_size : (i + 1) * block_size], bpp,
                    int(fsizes[i]), lz_table)
                if payload is not None:
                    pieces.append(bytes(stream[pos : starts[i]]))
                    pieces.append(bytes([BLOCK_LZ]))
                    pieces.append(payload)
                    pos = starts[i + 1]
                    shrink += bsizes[i] - (1 + len(payload))
                    self._sizes_after_lz[i] = 1 + len(payload)
        pieces.append(bytes(stream[pos:]))
        return b"".join(pieces)

    def decode_block_stream(self, payload, bpp, nbytes):
        """Decode one superblock's block stream: native row parse, then the
        decode kernel over its blocks; the partial tail comes decoded from
        the parser. Returns uint8 array or a negative error."""
        from .native import load

        native = load()
        payload = bytes(memoryview(np.asarray(payload)))
        block_size = 256 * bpp
        nb = 1 if nbytes == block_size else nbytes // block_size
        if nb == 0:  # only a partial tail: no 256-element block to decode
            return native.block_decode(payload, bpp, nbytes)
        parsed = native.parse_rows(payload, bpp, nbytes)
        if isinstance(parsed, int):
            return parsed
        vbuf, plane_off, row_rel, row_hdr, row_min, tail, _ = parsed
        rowtab = (row_rel | (row_hdr.astype(np.int32) << 10)
                  | (row_min.astype(np.int32) << 14)).T
        out = self._decode(vbuf[None], plane_off[None], rowtab[None], bpp, nb)
        out = out.reshape(-1)
        if len(tail):
            out = np.concatenate([out, tail])
        return out[:nbytes]

    def _decode(self, vbufs, plane_off, rowtab, bpp, nb) -> np.ndarray:
        dev = self.device
        out = decode_rows(_to_device(vbufs, dev), _to_device(plane_off, dev),
                          _to_device(rowtab, dev), bpp, nb)
        return out.cpu().numpy()


def decompress_frame_batched(frame: bytes, bpp: int, engine: TorchEngine):
    """Decode a whole frame when every superblock is method BLOCK with the
    same decoded size (the level-1 typed-array path): the native parser
    builds the row index of CHUNK_BYTES of superblocks at a time and one
    decode kernel launch decodes each chunk.

    Returns the decoded numpy array, or None when the frame does not have
    that shape (the caller then decodes per superblock). Raises
    StenosError(ERROR_INVALID_INPUT) when the parser rejects a record."""
    from .frame import StenosError, get_info
    from .native import load

    native = load()
    frame = bytes(frame)
    dsize_total, sb, pos = get_info(frame, bpp)
    block_size = 256 * bpp
    if dsize_total == 0 or sb % block_size or dsize_total % sb:
        return None
    n_sb = dsize_total // sb
    nb = sb // block_size
    offs, csizes = [], []
    p = pos
    for _ in range(n_sb):
        if p + 4 > len(frame) or frame[p] != 1:
            return None
        csize = int.from_bytes(frame[p + 1 : p + 4], "little")
        offs.append(p + 4)
        csizes.append(csize)
        p += 4 + csize
    per_call = max(1, CHUNK_BYTES // sb)
    row_bytes = max(csizes) + 32
    out = np.empty(dsize_total, np.uint8)
    for c0 in range(0, n_sb, per_call):
        c1 = min(c0 + per_call, n_sb)
        r = native.parse_rows_batch(frame, bpp, sb, offs[c0:c1],
                                    csizes[c0:c1], row_bytes)
        if isinstance(r, int):
            raise StenosError(ERROR_INVALID_INPUT)
        vbufs, plane_off, rowtab, _ = r
        out[c0 * sb : c1 * sb] = engine._decode(
            vbufs, plane_off, rowtab, bpp, nb).reshape(-1)
    return out


def roundtrip_device(batch, bpp: int, block_level: int = 2):
    """Device-resident compress -> decompress of a (n_sb, sbytes) uint8
    tensor, on its device, with no host byte traffic and no device-to-host
    copy: the index-mode encode emits the frame records and the decode index
    into rows of record_bound(nb, bpp) bytes, and the derive-mode decode
    reads the records directly (no row table, no host parse), only the bytes
    the index points at.

    Returns (out (n_sb, sbytes) uint8, rows (n_sb, record_bound) uint8,
    totals (n_sb,) int32): rows[i, :totals[i]] is a standard frame record,
    zeros follow."""
    n_sb, sbytes = batch.shape
    nb = sbytes // (256 * bpp)
    rows, totals, _, _, plane_off = encode_superblocks_index(
        batch, bpp, block_level, record_bound(nb, bpp))
    return decode_rows_derive(rows, plane_off, bpp, nb, "jb"), rows, totals


def frame_header_bytes(nbytes: int, sb: int, bpp: int, level: int) -> bytes:
    """Frame header of a device-assembled frame: the standard shift byte when
    sb is the level's superblock size, else the custom-blocksize form (shift
    255 + LE32 sb, stenos.cpp:868-874)."""
    from .frame import StenosError, _superblock_params

    try:
        std_sb, shift = _superblock_params(bpp, nbytes, level)
    except StenosError:  # no standard superblock for this size: custom form
        std_sb, shift = -1, 0
    if sb == std_sb:
        return bytes([shift]) + nbytes.to_bytes(7, "little")
    return (bytes([255]) + nbytes.to_bytes(7, "little")
            + sb.to_bytes(4, "little"))


def compress_frame_device(data, bpp: int, level: int):
    """Device-resident frame compression (every superblock method BLOCK) of a
    (n_sb, sb) uint8 tensor, on its device: the encode at block level 2 (as
    the JAX package's device path) writes each record straight to its place
    behind the frame header. No LZ patch-up and no fallback to COPY: the
    frame equals stenos_tpu's compress_frame_device_jit, and decodes with
    decompress.

    Returns (frame (capacity,) uint8, length): the frame is frame[:length];
    length is a 0-d int64 tensor on the device (no device-to-host copy)."""
    n_sb, sb = data.shape
    return encode_superblocks_frame(
        data, bpp, 2, frame_header_bytes(n_sb * sb, sb, bpp, level))
