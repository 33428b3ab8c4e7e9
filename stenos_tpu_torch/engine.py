"""Torch engine: the block codec's device work on a CUDA card (or, when the
caller asks for it, on the CPU through the kernels' plain versions).

The frame layer (frame.py) keeps method selection and the host stages; the
engine supplies the block streams and decodes them:

  encode  encode_batch -> ops.encode_kernel.encode_superblocks (the
          encode_blocks kernel) over 64 MiB rounds of full superblocks, then
          per superblock the host LZ patch-up (_patch_lz) and the abort and
          budget checks (finish_block_stream); encode_block_stream does both
          for one superblock (a container chunk, a frame's partial tail).
  decode  frame.decompress gathers every full-size METHOD_BLOCK and
          METHOD_BLOCK_ZSTD superblock 64 MiB at a time: prepare_blocks
          (host libzstd on the residuals, the native parse_rows_ptrs) runs
          on a thread while the batch before it goes through decode_blocks:
          pinned buffers, non_blocking copies ordered by CUDA events, one
          launch of ops.decode_kernel.decode_rows (the decode_rows kernel).
          Zstd superblocks go to entropy.device_decode, 64 MiB a call.
          One superblock alone (a container chunk, decompress_superblock):
          decode_block_stream, the native parse_rows, then one launch of
          decode_rows. decompress_frame_batched decodes a frame of
          METHOD_BLOCK superblocks only, 64 MiB a launch, through the same
          batcher, into a numpy array or (keep_device=True) into tensors
          left on the device. The threads, the pinned buffers and the copy
          into the output are host/staging.py's.

and two device-resident paths with no host byte traffic:

  roundtrip_device       encode_superblocks_index (records + decode index)
                         -> decode_rows_derive on the records themselves.
  compress_frame_device  encode_superblocks_frame: the same kernel writes
                         the records behind the frame header, in one buffer,
                         in one launch; a 1-D column of any length through
                         encode_column_frame (a short last superblock, its
                         partial segment by encode_short).
  compress_frames_device encode_superblocks_frames: a batch of images of
                         equal length, a frame each, one a row, in one
                         launch.

Counterpart of stenos_tpu/engine_jax.py (JaxEngine, decompress_frame_batched,
roundtrip_device, compress_frame_device_jit).
A device that is asked for and missing, a kernel that does not build or
launch, and a native runtime that does not build all raise: nothing here
falls back to a slower tier. An engine may serve several threads (compress
with threads=, a shared container): its device work runs under its lock.
"""

import sys
import threading

import numpy as np
import torch

from .codec.encode_np import encode_partial
from .codec.lz_np import fresh_table, lz_compress_block
from .constants import (BLOCK_LZ, BLOCK_PARTIAL, ERROR_DST_OVERFLOW,
                        ERROR_INVALID_INPUT, MAX_BLOCK_BYTES)
from .ops.decode_kernel import decode_rows, decode_rows_derive
from .ops.encode_kernel import (encode_column_frame, encode_superblocks,
                                encode_superblocks_frame,
                                encode_superblocks_frames,
                                encode_superblocks_index, record_bound)
from .host import staging
from .utils import trace

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
        self.lock = threading.Lock()  # held around each call's device work

    def _encode_rounds(self, batch: np.ndarray, bpp: int, block_level: int):
        """One device call over a (r, sb) batch -> per-superblock
        (stream, total, bsizes, fsizes) tuples on the host."""
        with self.lock:
            with trace.span("stn.upload", self.device, nbytes=batch.nbytes,
                            superblocks=batch.shape[0]):
                x = _to_device(batch, self.device)
            streams, totals, bsizes, fsizes = encode_superblocks(
                x, bpp, block_level)
            with trace.span("stn.readback", self.device):
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
        with trace.span("stn.encode_batch", nbytes=n_full * sb,
                        superblocks=n_full):
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
        body, sizes = self._patch_lz(stream[:total], chunk, bpp, nb, bsizes,
                                     fsizes, block_level, lz_table=lz_table)
        if target_ratio is not None:
            ends = np.cumsum(sizes)
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
            body, sizes = self._patch_lz(out[:total], chunk, bpp, nb, bsizes,
                                         fsizes, block_level,
                                         lz_table=lz_table)
            if target_ratio is not None:
                # abort check (block_compress.h:1267-1274) on the (possibly
                # LZ-patched) sizes
                ends = np.cumsum(sizes)
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
        """Host-side intra-block LZ attempts + splice (rare path) -> (the
        block stream, each block's size after it)."""
        sizes = bsizes.copy()
        if not (block_level == 2 and bpp % 4 == 0):
            return bytes(stream), sizes
        block_size = 256 * bpp
        cand = np.nonzero(fsizes * 3 > block_size)[0]
        if not len(cand):
            return bytes(stream), sizes
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
        with trace.span("stn.patch_lz", nbytes=len(chunk), superblocks=1):
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
                        sizes[i] = 1 + len(payload)
            pieces.append(bytes(stream[pos:]))
            return b"".join(pieces), sizes

    def decode_block_stream(self, payload, bpp: int, nbytes: int):
        """Decode one block stream (a METHOD_BLOCK payload or an unpacked
        METHOD_BLOCK_ZSTD residual) of nbytes: the native parse_rows, then
        one launch of decode_rows over its full blocks; a partial tail comes
        decoded from the parse. Less than one block is decoded on the host,
        as in the JAX engine. Returns a uint8 array, or a negative error."""
        from .native import load

        native = load()
        payload = bytes(memoryview(np.asarray(payload)))
        nb = nbytes // (256 * bpp)
        if nb == 0:
            return native.block_decode(payload, bpp, nbytes)
        parsed = native.parse_rows(payload, bpp, nbytes)
        if isinstance(parsed, int):
            return parsed
        vbufs, plane_off, rowtab, tail = parsed
        with self.lock:
            out = decode_rows(*(_to_device(a, self.device)
                                for a in (vbufs, plane_off, rowtab)),
                              bpp, nb).view(-1).cpu().numpy()
        return np.concatenate([out, tail]) if len(tail) else out

    def decode_blocks(self, prep, bpp: int, sb: int, bufs, host=None):
        """Decode a prepared batch (prepare_blocks, into the Staging bufs)
        with one launch of the decode kernel, under the engine's lock. On a
        CUDA device the parse output goes up by non_blocking copies from
        bufs' pinned buffers, on the current stream, and bufs.uploaded
        becomes the event behind them. host, a Staging, is the host sink:
        the decoded bytes come back into its pinned buffer "decoded", the
        host waits for the stream once, at the end, and the n_ok * sb bytes
        return as a numpy array (a view of host's buffer until the next
        batch). host=None is the device sink: the (n_ok * sb,) uint8
        tensor on the device returns, and nothing waits."""
        dev, nb, n = self.device, sb // (256 * bpp), prep["n_ok"]
        with self.lock:
            with trace.span("stn.h2d", dev) as h2d:
                args = [a.to(dev, non_blocking=True) for a in prep["args"]]
            if dev.type == "cuda":
                bufs.uploaded = torch.cuda.Event()
                bufs.uploaded.record()
            with trace.span("stn.k2", dev, nbytes=n * sb,
                            superblocks=n) as k2:
                dec = decode_rows(*args, bpp, nb).view(-1)
            if host is None:
                return dec
            if dev.type != "cuda":
                return dec.numpy()
            out = host.get("decoded", dec.numel())
            with trace.span("stn.d2h", dev, nbytes=n * sb) as d2h:
                out.copy_(dec, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
        if timing is not None:
            prep["times"].update(h2d_ms=h2d.device_ms(),
                                 k2_ms=k2.device_ms(),
                                 d2h_ms=d2h.device_ms())
        return out.numpy()


# the default of an entry point's engine= (Context, CompressedArray and the
# package's compress / decompress): a TorchEngine on its device= argument
DEFAULT = object()


def resolve(engine, device):
    """The engine an entry point runs: for DEFAULT a TorchEngine on `device`
    ("cuda" unless given; it raises when CUDA is absent), else engine itself
    (None: the numpy host path)."""
    if engine is DEFAULT:
        return TorchEngine("cuda" if device is None else device)
    if device is not None:
        raise ValueError("pass either engine= or device=, not both")
    return engine


# per-batch times of the block decode (chip_smoke.py reads them), appended
# to when this is a list: the host pass on its thread (unpack_ms, parse_ms),
# how long the decode waited for it (wait_ms), and, for a batch copied to
# the host, on a CUDA device h2d_ms, k2_ms and d2h_ms by CUDA events, how
# long it waited for the batch before's copy into the output (out_wait_ms)
# and that copy (out_ms), each the time of a span of utils/trace.py; set,
# it also turns that recorder on
timing = None


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def prepare_blocks(frame: np.ndarray, items, bpp: int, sb: int, bufs):
    """Host pass of one batch of full-size METHOD_BLOCK / METHOD_BLOCK_ZSTD
    superblocks of a frame (uint8 array), in native code on
    staging.HOST_THREADS threads: host libzstd unpacks each residual into
    its declared content size (native.zstd_unpack), then the parser
    (native.parse_rows_ptrs) builds the row index of every block stream,
    where it lies, into bufs' buffers (pinned on a CUDA device). items:
    (code, pos, csize, written), the payload at frame[pos : pos + csize].
    Returns a dict: n_ok, the superblocks before the first one that does
    not unpack or parse (all of them when every one does), the kernel's
    args (vbufs, plane_off, rowtab) over those, and times."""
    from .constants import METHOD_BLOCK
    from .native import load

    native = load()
    with trace.span("stn.unpack", superblocks=len(items)) as unpack:
        spans = np.array([it[1:3] for it in items], np.int64).reshape(-1, 2)
        srcs = frame.ctypes.data + spans[:, 0]
        lens = spans[:, 1].copy()
        zst = np.array([i for i, it in enumerate(items)
                        if it[0] != METHOD_BLOCK], np.int64)
        n_ok = len(items)
        if len(zst):
            res, starts, n_z = native.zstd_unpack(
                srcs[zst], lens[zst], MAX_BLOCK_BYTES,
                staging.HOST_THREADS)
            srcs[zst[:n_z]] = res.ctypes.data + starts[:n_z]
            lens[zst[:n_z]] = np.diff(starts[: n_z + 1])
            if n_z < len(zst):
                n_ok = int(zst[n_z])
    m = n_ok
    P = sb // 256
    srcs, lens = srcs[:m], lens[:m]
    rb = _up16(int(lens.max()) + 32) if m else 16
    with trace.span("stn.parse", superblocks=m) as parse:
        while m:
            vb = bufs.get("vbufs", m * rb).view(m, rb)
            po = bufs.get("plane_off", m * P * 4).view(torch.int32).view(m, P)
            rt = bufs.get("rowtab", m * 16 * P * 4).view(torch.int32).view(
                m, 16, P)
            i, err = native.parse_rows_ptrs(
                srcs, lens, bpp, sb, rb, vb.numpy(), po.numpy(), rt.numpy(),
                np.empty(m, np.int64), staging.HOST_THREADS)
            wide = _up16(int(lens.max()) + sb + 16)
            if err == ERROR_INVALID_INPUT and rb < wide:
                rb = wide  # LZ inlining grew a stream past its row: once wider
                continue
            n_ok = i
            break
    times = {"unpack_ms": unpack.host_ms, "parse_ms": parse.host_ms}
    args = None
    if n_ok:
        args = (vb[:n_ok], po[:n_ok], rt[:n_ok])
    return {"n_ok": n_ok, "args": args, "times": times}


def _block_records(frame: np.ndarray, bpp: int, tail: bool = False):
    """(sb, items) of a frame whose every full superblock is a METHOD_BLOCK
    record, items as prepare_blocks takes them; None when the frame is
    empty, its superblock is no whole number of blocks, it has no full
    superblock, a full superblock's record is of another method, or a
    record runs past the frame. tail=False also takes None for a size that
    is no whole number of superblocks; tail=True takes such a frame, and
    the partial superblock's record, of any method, is the last item."""
    from .constants import METHOD_BLOCK
    from .frame import get_info

    dsize, sb, pos = get_info(frame[:12].tobytes(), bpp)
    if dsize == 0 or sb % (256 * bpp) or (dsize % sb and not tail):
        return None
    n_sb = dsize // sb
    if n_sb == 0:
        return None
    items = []
    for i in range(n_sb + (dsize % sb > 0)):
        if pos + 4 > len(frame):
            return None
        code = int(frame[pos])
        csize = int.from_bytes(frame[pos + 1 : pos + 4].tobytes(), "little")
        if (code != METHOD_BLOCK and i < n_sb) or pos + 4 + csize > len(frame):
            return None
        items.append((code, pos + 4, csize, i * sb))
        pos += 4 + csize
    return sb, items


def decompress_frame_batched(frame, bpp: int, engine=None,
                             keep_device: bool = False, device=None):
    """Decode a frame whose every superblock is a full-size METHOD_BLOCK
    record (the level-1 typed-array fast path), as the JAX package's
    decompress_frame_batched.

    Returns the decoded bytes as a uint8 numpy array (frame.decompress on
    the engine: its batcher), or None when the frame does not fit the fast
    path (an empty frame, a superblock that is no whole number of blocks, a
    size that is no whole number of superblocks, a record of another
    method, a superblock that does not decode): the caller then takes
    frame.decompress.

    keep_device=True returns a list of 1-D uint8 tensors on the engine's
    device, one a batch of CHUNK_BYTES, whose bytes in order are the
    decoded array: nothing is copied back to the host. The batches go
    through frame.decompress's batcher (frame._BlockChunk) with its device
    sink: one launch of the decode kernel (decode_rows) each, the host pass
    of a batch (prepare_blocks) on a thread while the batch before it
    decodes.

    engine: a TorchEngine; None makes one on `device` ("cuda" unless given,
    raising when CUDA is absent)."""
    from .frame import StenosError, _BlockChunk, decompress

    if engine is None:
        engine = TorchEngine("cuda" if device is None else device)
    elif device is not None:
        raise ValueError("pass either engine= or device=, not both")
    frame = np.ascontiguousarray(np.frombuffer(bytes(frame), np.uint8))
    found = _block_records(frame, bpp)
    if found is None:
        return None
    try:
        if not keep_device:
            return decompress(frame, bpp, engine=engine)
        sb, items = found
        blocks = _BlockChunk(engine, bpp, sb, frame, None)
        with trace.span("stn.decompress_frame_batched",
                        nbytes=len(items) * sb, superblocks=len(items)):
            for item in items:
                blocks.add(item, sb)
            blocks.flush()
        return blocks.outs
    except StenosError:
        return None


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


# device frame compresses of a column whose frame ends in a short
# superblock, and of those the ones whose short superblock is under
# SMALL_INPUT bytes (chip_smoke.py and the tests read these)
short_superblocks = 0
short_superblocks_small = 0
SMALL_INPUT = 128  # a shorter superblock is ZSTD or COPY (compress_superblock)


def compress_frame_device(data, bpp: int, level: int):
    """Device-resident frame compression of a uint8 tensor, on its device:
    every superblock a METHOD_BLOCK record encoded at block level 2 (as the
    JAX package's device path) and written straight to its place behind
    the frame header. No LZ patch-up and no fallback to COPY: the frame
    equals stenos_tpu's compress_frame_device_jit and, where the host
    path's frame has no LZ block and no COPY record, the host path's frame
    at level 1; it decodes with decompress.

    data is (n_sb, sb), whole superblocks of any size that is a whole
    number of blocks (one launch), or a contiguous 1-D column of any
    length, whose superblocks are the level's. A column that is no whole
    number of them ends in a short superblock of r bytes: its whole blocks
    ride as one more row of K1, which places their record with the others,
    and the partial segment of the bytes past them is encoded on the card
    behind it (encode_short): two launches (ops/encode_kernel.py
    encode_column_frame). Under SMALL_INPUT bytes it takes the library's
    small-input route, its one host step: the r bytes are copied to the
    host (waiting for the card) and compressed there by libzstd (a ZSTD
    record, or COPY where that does not shrink them), and the record is
    written behind the whole superblocks' frame on the card.

    Returns (frame (capacity,) uint8, length): the frame is frame[:length],
    zeros follow; length is a 0-d int64 tensor on the device (no
    device-to-host copy)."""
    global short_superblocks, short_superblocks_small
    if data.dim() == 2:
        n_sb, sb = data.shape
        with trace.span("stn.compress_frame_device", nbytes=n_sb * sb,
                        superblocks=n_sb):
            return encode_superblocks_frame(
                data, bpp, 2, frame_header_bytes(n_sb * sb, sb, bpp, level))
    from .frame import _superblock_params

    nbytes = data.numel()
    if data.dim() != 1 or data.dtype != torch.uint8 or not nbytes:
        raise ValueError("compress_frame_device: need a (n_sb, sb) or a "
                         "non-empty 1-D uint8 tensor")
    sb = _superblock_params(bpp, nbytes, level)[0]
    header = frame_header_bytes(nbytes, sb, bpp, level)
    n_full, r = divmod(nbytes, sb)
    with trace.span("stn.compress_frame_device", nbytes=nbytes,
                    superblocks=n_full + (r > 0)):
        if not r:
            return encode_superblocks_frame(data.view(n_full, sb), bpp, 2,
                                            header)
        short_superblocks += 1
        if r >= SMALL_INPUT:
            return encode_column_frame(data, bpp, 2, header, sb)
        short_superblocks_small += 1
        return _small_tail_frame(data, bpp, level, header, sb)


# frames written by compress_frames_device (chip_smoke.py and the tests
# read it)
frames_batched = 0


def compress_frames_device(frames, bpp: int, level: int):
    """Device-resident compression of a batch of images, a frame each:
    frames is a contiguous (F, n) uint8 tensor, F images of n bytes, and
    frame f is compress_frame_device's frame of image f (every superblock
    a METHOD_BLOCK record at block level 2, no LZ patch-up, no COPY): the
    host path's frame of that image alone at level 1 where that frame has
    no LZ block and no COPY record. n must be a whole number of the level's
    superblocks for an n-byte frame; a short last superblock is not taken
    (ValueError).

    One launch of K1 for the whole batch (ops/encode_kernel.py
    encode_superblocks_frames), no host synchronisation. Returns (out (F,
    stride) uint8, lengths (F,) int64 tensor on the device): frame f is
    out[f, :lengths[f]], zeros follow; stride is the header's length plus
    n / sb record bounds, rounded up to a multiple of 16. F = 1 gives
    compress_frame_device's frame of frames[0]."""
    global frames_batched
    from .frame import StenosError, _superblock_params

    if (frames.dim() != 2 or frames.dtype != torch.uint8
            or not frames.is_contiguous() or 0 in frames.shape or bpp < 1):
        raise ValueError("compress_frames_device: need a contiguous, "
                         "non-empty (F, n) uint8 tensor and bytesoftype "
                         "1 or more")
    n_frames, n = frames.shape
    try:
        sb = _superblock_params(bpp, n, level)[0]
    except StenosError as e:
        raise ValueError(f"compress_frames_device: no superblock for "
                         f"bytesoftype {bpp}, level {level}") from e
    if n % sb:
        raise ValueError(f"compress_frames_device: a frame of {n} bytes is "
                         f"no whole number of the level's {sb}-byte "
                         "superblocks")
    n_sb = n // sb
    with trace.span("stn.compress_frames_device", frames.device,
                    nbytes=n_frames * n, superblocks=n_frames * n_sb,
                    frames=n_frames):
        out = encode_superblocks_frames(
            frames.view(n_frames * n_sb, sb), bpp, 2,
            frame_header_bytes(n, sb, bpp, level), n_frames)
    frames_batched += n_frames
    return out


def _small_tail_frame(data, bpp: int, level: int, header: bytes, sb: int):
    """compress_frame_device's small-input route: the whole superblocks'
    frame on the card with 4 + r spare bytes of capacity, then, under the
    span stn.short_superblock, the last r < SMALL_INPUT bytes through the
    host path's compress_superblock (libzstd's ZSTD record, else COPY),
    written at the frame's length on the card."""
    from .frame import compress_superblock

    dev = data.device
    n_full, r = divmod(data.numel(), sb)
    if n_full:
        frame, length = encode_superblocks_frame(
            data[: n_full * sb].view(n_full, sb), bpp, 2, header, r + 4)
    else:
        frame = torch.zeros(len(header) + r + 4, dtype=torch.uint8,
                            device=dev)
        length = torch.full((), len(header), dtype=torch.int64, device=dev)
    with trace.span("stn.short_superblock", dev, nbytes=r, superblocks=1):
        rec = compress_superblock(data[n_full * sb :].cpu().numpy(), bpp,
                                  level, r + 4)
        if not n_full:
            frame[: len(header)] = torch.tensor(list(header),
                                                dtype=torch.uint8)
        # r + 4 bytes from the length on: the record, then zeros
        window = torch.zeros(r + 4, dtype=torch.uint8)
        window[: len(rec)] = torch.frombuffer(bytearray(rec),
                                              dtype=torch.uint8)
        frame.index_copy_(0, length + torch.arange(r + 4, device=dev),
                          window.to(dev))
    return frame, length + len(rec)


trace.switch(sys.modules[__name__])
