"""Frame layer: superblock orchestration and method selection (SPEC.md §1, §4).

Behavioral equivalent of stenos.cpp:403-1017 / 1052-1208, ported from
stenos_tpu/frame.py, the time-limited mode (compress_generic with a
Context's budget), the host-thread fan-out (threads=) and the private block
API included. The per-superblock block codec is delegated to an engine:
None is the numpy host path (codec/encode_np.py, native block decode), the
parity oracle; a TorchEngine runs it through the encode and decode kernels;
engine="auto" takes a TorchEngine on "cuda" for large inputs and the host
path below. The zstd entropy stage is host libzstd, unless compress is given
entropy="device" (entropy/zstd_frame.py on the engine's device, or on the
default device without one); with an engine, the block streams of methods
BLOCK and BLOCK_ZSTD decode through the decode kernel and the payloads of
methods ZSTD, TRANSPOSED_ZSTD and TRANSPOSED_DELTA_ZSTD on its device
(entropy/device_decode.py), each up to 64 MiB of superblocks a call; host
libzstd takes only the zstd payloads handed back. The LZ4 estimators, the
LZ patch-up and the rate controllers stay host code.
"""

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from .codec.encode_np import block_codec_encode
from .constants import (
    ERROR_DST_OVERFLOW,
    ERROR_INVALID_BYTESOFTYPE,
    ERROR_INVALID_INPUT,
    ERROR_SRC_OVERFLOW,
    MAX_BLOCK_BYTES,
    MAX_BYTESOFTYPE,
    METHOD_BLOCK,
    METHOD_BLOCK_ZSTD,
    METHOD_COPY,
    METHOD_TRANSPOSED_DELTA_ZSTD,
    METHOD_TRANSPOSED_ZSTD,
    METHOD_ZSTD,
    NO_BLOCK_SHIFT,
    compress_bound,
    super_block_size,
)
from .host import staging
from .host import zstd as zstd_host
from .host.lz4dry import lz4_guess_ratio, lz4_guess_size
from .ops.delta import delta_inv_np, delta_np
from .ops.shuffle import shuffle_np, unshuffle_np
from .utils import trace
from .utils.demote import warn_once

# engine="auto" takes the device at or above these input sizes (the JAX
# package's thresholds; the bytes are the same either way)
AUTO_COMPRESS_BYTES = 4 * 1024 * 1024
AUTO_DECOMPRESS_BYTES = 1024 * 1024


class StenosError(Exception):
    def __init__(self, code):
        self.code = code
        super().__init__(f"stenos error {code}")


def strong_debug() -> bool:
    """STENOS_STRONG_DEBUG analog (block_compress.h:28,1077-1097): when the
    env flag is set, every superblock encode is decode-verified against its
    input before being emitted, and the container round-trips every chunk
    compression (cvector.hpp:1396-1407)."""
    return os.environ.get("STENOS_STRONG_DEBUG", "") not in ("", "0")


def _auto_engine(nbytes: int, threshold: int):
    """engine="auto": a TorchEngine on "cuda" (raising when there is none)
    for nbytes >= threshold, else the host path."""
    if nbytes < threshold:
        return None
    from .engine import TorchEngine

    return TorchEngine("cuda")


def _superblock_params(bpp, nbytes, level, custom_shift=None):
    """Superblock size + frame shift byte (stenos.cpp:115-169)."""
    block_size = bpp * 256
    if custom_shift is not None and custom_shift != NO_BLOCK_SHIFT:
        sb = block_size << custom_shift
        shift = 255
    else:
        sb = super_block_size(block_size)
        shift = 0
        if nbytes > sb:
            shift = (level - 1) // 2 if level else 0
            sb <<= shift
    if sb < block_size or sb >= MAX_BLOCK_BYTES:
        raise StenosError(-9)  # ERROR_INVALID_PARAMETER
    return sb, shift


def _guess_transposed_lz_ratio(shuffled, bpp, nbytes, glevel, use_delta):
    """stenos.cpp:376-401 — windowed per-plane LZ4 estimate."""
    elements = nbytes // bpp
    stepsize = elements // (16 // (glevel - 1))
    if stepsize < 64:
        stepsize = elements
    csize = 0
    processed = 0
    for p in range(bpp):
        start = p * elements + (elements - stepsize) // 2
        window = shuffled[start : start + stepsize]
        if use_delta:
            window = delta_np(window)
        csize += lz4_guess_size(window.tobytes(), 10 - glevel)
        processed += stepsize
    return (processed / csize) * (1.0 + glevel * 0.02)


def _verify_superblock(method, payload, chunk, bpp, engine):
    """Decode-and-compare one just-encoded superblock (the
    STENOS_STRONG_DEBUG contract, block_compress.h:1077-1097, lifted to the
    frame layer so every method path is covered)."""
    back = decompress_superblock(
        method, np.frombuffer(bytes(payload), np.uint8), bpp, len(chunk),
        engine)
    if bytes(memoryview(np.asarray(back))) != chunk.tobytes():
        raise AssertionError(
            "STENOS_STRONG_DEBUG: superblock round-trip mismatch "
            f"(method {method})")


def _check_entropy(entropy):
    if entropy not in (None, "device"):
        raise ValueError(f"unknown entropy stage {entropy!r}")


# device work of entropy="device" without an engine (an engine has its lock)
_coder_lock = threading.Lock()


def _entropy_compress(src_bytes, cap: int, zl: int, entropy, engine,
                      device=None):
    """The zstd stage: libzstd (byte parity with the reference), or with
    entropy="device" the device entropy coder (standard zstd output and a
    decode-anchor sidecar) on the engine's device, or without an engine on
    `device` ("cuda" unless given: the JAX package runs it on its default
    device)."""
    if entropy == "device":
        from .entropy.zstd_frame import encode_frame_device

        lock, dev = ((engine.lock, engine.device) if engine is not None
                     else (_coder_lock, device or "cuda"))
        with lock:
            f = encode_frame_device(src_bytes, device=dev)
        return "overflow" if len(f) > cap else f
    return zstd_host.compress(src_bytes, cap, zl)


def compress_superblock(chunk: np.ndarray, bpp: int, level: int,
                        dst_size: int, engine=None, precomputed=None,
                        entropy=None, lz_table=None, device=None) -> bytes:
    """Compress one superblock -> header(4B) + payload (or raise).

    Mirrors compress_generic_superblock (stenos.cpp:403-679),
    non-time-limited path. device: where entropy="device" runs without an
    engine ("cuda" unless given).
    """
    _check_entropy(entropy)
    sbytes = len(chunk)
    if dst_size < 4:
        raise StenosError(ERROR_DST_OVERFLOW)

    def emit(method, payload):
        if 4 + len(payload) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        if strong_debug():
            _verify_superblock(method, payload, chunk, bpp, engine)
        return bytes([method]) + len(payload).to_bytes(3, "little") + payload

    def do_memcpy():
        if dst_size < sbytes + 4:
            raise StenosError(ERROR_DST_OVERFLOW)
        return emit(METHOD_COPY, chunk.tobytes())

    def do_zstd(src_bytes, method, zl):
        r = _entropy_compress(src_bytes, dst_size - 4, zl, entropy, engine,
                              device)
        if isinstance(r, str) or len(r) > sbytes:
            return do_memcpy()
        return emit(method, r)

    if sbytes == 0 or level == 0:
        return do_memcpy()
    if sbytes < 128:
        return do_zstd(chunk.tobytes(), METHOD_ZSTD, 0)

    # zstd level (stenos.cpp:439-461), SSE path semantics
    zl = 0
    if bpp > 1:
        if level < 2:
            # pure block path (goto BLOCK); the frame-scoped LZ table rides
            # along (level-1 single-thread reference semantics)
            r = _encode_blocks(chunk, bpp, dst_size - 4, None, engine,
                               precomputed, lz_table=lz_table)
            if isinstance(r, int) or len(r) > sbytes:
                return do_memcpy()
            return emit(METHOD_BLOCK, r)
        zl = level - 1
        if zl >= 4:
            zl += 1
    else:
        zl = level

    glevel = level
    lz_ratio = 1.1
    lz_transposed = 0.0
    lz_transposed_delta = 0.0
    if sbytes >= bpp * 256:
        # NB: overwrites (not max) — stenos.cpp:469,492-495
        lz_ratio = lz4_guess_ratio(chunk[: sbytes // 16].tobytes(),
                                   10 - glevel)

    shuffled = None
    if bpp > 1:
        shuffled = shuffle_np(chunk, bpp)
        if sbytes >= bpp * 256 and level > 2:
            lz_transposed = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, False)
            lz_ratio = max(lz_ratio, lz_transposed)
            lz_transposed_delta = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, True) * 1.1
            lz_ratio = max(lz_ratio, lz_transposed_delta)
            factor = 1.0 + level / 12.0
            lz_transposed *= factor
            lz_transposed_delta *= factor
            lz_ratio *= factor
    else:
        lz_ratio *= 1.0 + level / 12.0

    # block codec with target-ratio abort; budget = sbytes (stenos.cpp:546-547)
    cblock = _encode_blocks(chunk, bpp, sbytes, lz_ratio, engine, precomputed)
    if isinstance(cblock, int) or len(cblock) > sbytes:
        if lz_ratio > 1.40:
            if lz_ratio == lz_transposed:
                return do_zstd(shuffled.tobytes(), METHOD_TRANSPOSED_ZSTD, zl)
            if lz_ratio == lz_transposed_delta:
                return do_zstd(delta_np(shuffled).tobytes(),
                               METHOD_TRANSPOSED_DELTA_ZSTD, zl)
        return do_zstd(chunk.tobytes(), METHOD_ZSTD, zl)

    result = _entropy_compress(cblock, dst_size - 4, zl, entropy, engine,
                               device)
    if isinstance(result, str) or len(result) > len(cblock):
        return emit(METHOD_BLOCK, cblock)
    return emit(METHOD_BLOCK_ZSTD, result)


def _encode_blocks(chunk, bpp, budget, target_ratio, engine, precomputed=None,
                   block_level=2, lz_table=None):
    if precomputed is not None and engine is not None:
        return engine.finish_block_stream(precomputed, chunk, bpp, budget,
                                          target_ratio, block_level,
                                          lz_table=lz_table)
    if engine is not None:
        return engine.encode_block_stream(chunk, bpp, budget, target_ratio,
                                          block_level, lz_table=lz_table)
    return block_codec_encode(chunk, bpp, budget, block_level, target_ratio,
                              lz_table=lz_table)


def compress_superblock_timed(ctx, chunk: np.ndarray, bpp: int,
                              dst_size: int, engine=None, precomputed=None,
                              blevel_override=None) -> bytes:
    """Time-limited superblock compression (stenos.cpp:463-679 with the
    chunk-granular controller from context.py).

    precomputed/blevel_override: the batched-round path (one encode call
    per ROUND of superblocks) hands each chunk its precomputed block stream
    and the round's block level, so decisions stay consistent with what the
    encode kernel already encoded."""
    from .context import clevel_for_remaining, find_block_level

    t = ctx.t
    sbytes = len(chunk)
    if dst_size < 4:
        raise StenosError(ERROR_DST_OVERFLOW)

    def emit(method, payload):
        if 4 + len(payload) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        if strong_debug():
            _verify_superblock(method, payload, chunk, bpp, engine)
        return bytes([method]) + len(payload).to_bytes(3, "little") + payload

    def do_memcpy():
        if dst_size < sbytes + 4:
            raise StenosError(ERROR_DST_OVERFLOW)
        return emit(METHOD_COPY, chunk.tobytes())

    def do_zstd(src_bytes, method):
        zl = clevel_for_remaining(t, t.processed_bytes)
        if zl <= 0:
            return do_memcpy()
        r = zstd_host.compress(src_bytes, dst_size - 4, zl)
        if isinstance(r, str) or len(r) > sbytes:
            return do_memcpy()
        return emit(method, r)

    if sbytes == 0 or t.finish_memcpy:
        return do_memcpy()
    if sbytes < 128:
        return do_zstd(chunk.tobytes(), METHOD_ZSTD)

    target_speed = t.requested_speed()
    # estimator level from requested speed (stenos.cpp:477-490)
    if target_speed < 10e6:
        glevel = 9
    elif target_speed < 40e6:
        glevel = 8
    elif target_speed < 100e6:
        glevel = 7
    elif target_speed < 200e6:
        glevel = 6
    elif target_speed < 400e6:
        glevel = 5
    else:
        glevel = 2

    blevel = find_block_level(t, 0) if blevel_override is None \
        else blevel_override
    if blevel == -2:
        t.finish_memcpy = True
        return do_memcpy()
    if blevel == -1:
        return do_memcpy()

    lz_ratio = 1.1
    if target_speed < 600e6 and sbytes >= bpp * 256:
        lz_ratio = lz4_guess_ratio(chunk[: sbytes // 16].tobytes(), 10 - glevel)

    if target_speed > 1.5e9 and bpp > 1:
        r = _encode_blocks(chunk, bpp, dst_size - 4, None, engine,
                           precomputed=precomputed, block_level=blevel)
        if isinstance(r, int) or len(r) > sbytes:
            return do_memcpy()
        return emit(METHOD_BLOCK, r)

    lz_transposed = lz_transposed_delta = 0.0
    shuffled = None
    if bpp > 1:
        shuffled = shuffle_np(chunk, bpp)
        if target_speed < 600e6 and sbytes >= bpp * 256:
            lz_transposed = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, False)
            lz_ratio = max(lz_ratio, lz_transposed)
            lz_transposed_delta = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, True) * 1.1
            lz_ratio = max(lz_ratio, lz_transposed_delta)
            if target_speed < 2e6:
                factor = 1.0 + 9 / 12.0
                lz_transposed *= factor
                lz_transposed_delta *= factor
                lz_ratio *= factor
    elif target_speed < 2e6:
        lz_ratio *= 1.0 + 9 / 12.0

    tick = t.elapsed()
    cblock = _encode_blocks(chunk, bpp, sbytes, lz_ratio, engine,
                            precomputed=precomputed, block_level=blevel)
    if isinstance(cblock, int) or len(cblock) > sbytes:
        if lz_ratio > 1.40:
            if lz_ratio == lz_transposed:
                return do_zstd(shuffled.tobytes(), METHOD_TRANSPOSED_ZSTD)
            if lz_ratio == lz_transposed_delta:
                return do_zstd(delta_np(shuffled).tobytes(),
                               METHOD_TRANSPOSED_DELTA_ZSTD)
        return do_zstd(chunk.tobytes(), METHOD_ZSTD)

    # zstd level from measured block speed vs target (stenos.cpp:560-580)
    el = t.elapsed()
    block_el = max(el - tick, 1)
    processed = t.processed_bytes + len(cblock)
    global_speed = processed / (el * 1e-9)
    current_speed = sbytes / (block_el * 1e-9)
    zl = 0
    if global_speed > target_speed and current_speed > target_speed:
        zstd_rate = (current_speed * target_speed) / (
            current_speed - target_speed)
        zl = clevel_for_remaining(t, processed, target_rate=zstd_rate, shift=1)
    if zl < 1:
        if 4 + len(cblock) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        return emit(METHOD_BLOCK, cblock)
    result = zstd_host.compress(cblock, dst_size - 4, zl)
    if isinstance(result, str) or len(result) > len(cblock):
        return emit(METHOD_BLOCK, cblock)
    return emit(METHOD_BLOCK_ZSTD, result)


def private_block_size(src) -> int:
    """stenos_private_block_size parity (stenos.cpp:806-816): compressed
    record size (code byte + 3-byte csize + payload) of the superblock
    record at src."""
    src = bytes(memoryview(src)[:4])
    if len(src) < 4:
        raise StenosError(ERROR_SRC_OVERFLOW)
    return int.from_bytes(src[1:4], "little") + 4


def private_block_csize(src) -> int:
    """stenos_private_block_csize parity (stenos.cpp:817-828)."""
    if not src:
        return 0
    return private_block_size(src)


def private_compress_block(ctx, data, bytesoftype: int,
                           super_block_size: int, dst_size=None) -> bytes:
    """stenos_private_compress_block parity (stenos.cpp:768-779): one
    superblock record (the cvector bucket unit), context-driven."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), np.uint8)
    if dst_size is None:
        dst_size = compress_bound(len(data))
    return compress_superblock(data, bytesoftype, ctx.level, dst_size,
                               engine=ctx.engine)


def private_decompress_block(ctx, src, bytesoftype: int,
                             super_block_size: int, nbytes: int):
    """stenos_private_decompress_block parity (stenos.cpp:780-805)."""
    src = bytes(memoryview(src))
    if len(src) < 4:
        raise StenosError(ERROR_SRC_OVERFLOW)
    code = src[0]
    csize = int.from_bytes(src[1:4], "little")
    if len(src) < 4 + csize:
        raise StenosError(ERROR_SRC_OVERFLOW)
    return decompress_superblock(code, src[4 : 4 + csize], bytesoftype,
                                 nbytes, engine=ctx.engine)


def private_create_compression_header(decompressed_size: int,
                                      super_block_size: int) -> bytes:
    """stenos_private_create_compression_header parity
    (stenos.cpp:829-843): custom-superblock frame header (code 255)."""
    return (bytes([255]) + decompressed_size.to_bytes(7, "little")
            + super_block_size.to_bytes(4, "little"))


def decompress_generic(ctx, frame, bytesoftype: int, dst_size=None):
    """stenos_decompress_generic equivalent (stenos.h:211): decompress
    driven by a Context, which supplies the engine and, when it has one,
    the mesh."""
    return decompress(frame, bytesoftype, dst_size=dst_size,
                      engine=ctx.engine, mesh=getattr(ctx, "mesh", None))


def compress_generic(ctx, data, bytesoftype: int, dst_size=None) -> bytes:
    """stenos_compress_generic equivalent driven by a Context (incl.
    time-limited mode)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    nbytes = len(data)
    if bytesoftype == 0 or bytesoftype >= MAX_BYTESOFTYPE:
        raise StenosError(ERROR_INVALID_BYTESOFTYPE)
    if not ctx.t.nanoseconds:
        return compress(data, bytesoftype, ctx.level, dst_size,
                        engine=ctx.engine, custom_shift=ctx.blocksize_shift,
                        threads=ctx.threads)
    if dst_size is None:
        dst_size = compress_bound(nbytes)
    from .context import record_timed_call, timed_floor_ns

    kind = "host" if ctx.engine is None else "engine"
    t0 = time.perf_counter_ns()
    try:
        return _compress_timed(ctx, data, bytesoftype, dst_size, nbytes,
                               kind, timed_floor_ns(kind))
    finally:
        record_timed_call(kind, time.perf_counter_ns() - t0)


def _compress_timed(ctx, data, bytesoftype, dst_size, nbytes, kind, floor):
    """Time-limited compress body. `floor` = the fastest end-to-end timed
    call of this backend so far in this process (None before the first): a
    budget below it cannot be met (the reference's sub-ms overshoot,
    stenos.h:152-154, assumes no per-call floor), so the call says so once
    and records it in ctx.t.unsatisfiable. It still runs: the memcpy
    self-rescue bounds the overshoot."""
    sb, shift = ctx.prepare_superblock(bytesoftype, nbytes)
    ctx.t.start(nbytes)
    if floor is not None and ctx.t.nanoseconds < floor * 0.9:
        ctx.t.unsatisfiable = True
        warn_once(
            f"timed-floor-{kind}",
            f"max_nanoseconds={ctx.t.nanoseconds} is below this backend's "
            f"measured warm floor (~{floor} ns end-to-end, '{kind}' path): "
            f"the budget cannot be met; expect ~floor elapsed with memcpy "
            f"output")
    header = bytes([shift]) + nbytes.to_bytes(7, "little")
    if shift == 255:
        header += sb.to_bytes(4, "little")
    if len(header) > dst_size:
        raise StenosError(ERROR_DST_OVERFLOW)
    if nbytes == 0:
        return header
    out = [header]
    pos = len(header)
    if ctx.engine is not None:
        return b"".join(_timed_rounds(ctx, data, bytesoftype, dst_size, sb,
                                      out, pos))
    for off in range(0, nbytes, sb):
        chunk = data[off : off + sb]
        blob = compress_superblock_timed(ctx, chunk, bytesoftype,
                                         dst_size - pos)
        ctx.t.processed_bytes += len(chunk)
        out.append(blob)
        pos += len(blob)
    return b"".join(out)


def _bucket_down(r: int) -> int:
    """Largest power of two <= r (r >= 1)."""
    return 1 << (r.bit_length() - 1)


def next_round_size(recent_rates, rem_t: float, sb: int,
                    max_r: int = 64) -> int:
    """Superblocks for the next timed round.

    Sized to ~25% of the remaining budget at the CONSERVATIVE (minimum of
    the recent rounds) rate, so a round started now overshoots the deadline
    only if throughput drops below anything recently observed. The
    reference bounds overshoot per work item the same way via its
    per-chunk deadline check (stenos.cpp:936-965); here the bound is one
    shrinking round. Rounds are bucketed DOWN to powers of two, as in the
    JAX package, which keeps the conservative sizing and gives the same
    rounds for the same rates."""
    if not recent_rates:
        return 1
    rate_lo = min(recent_rates)
    return _bucket_down(max(1, min(max_r, int(rate_lo * rem_t * 0.25 / sb))))


def _timed_rounds(ctx, data, bpp: int, dst_size: int, sb: int, out, pos):
    """Batch-granular time-limited compression with an engine: one
    encode_batch (one encode-kernel launch a 64 MiB call) per ROUND of
    superblocks, the controller fed by measured round rates. The
    translation of the reference's thread-pool rounds (stenos.cpp:936-965)
    with TimeConstraint semantics at round granularity."""
    from .context import find_block_level

    t = ctx.t
    engine = ctx.engine
    nbytes = len(data)
    n_full = nbytes // sb
    i = 0
    R = 1            # calibration round, then rate-sized
    # the last few measured ENCODE round rates (bytes/sec). Memcpy rounds
    # are left out: their memcpy-speed rates would evict the slow encode
    # rates from this window, and the next encode round after the
    # controller catches up would be sized for memcpy throughput, one
    # oversized round past the budget
    recent = []
    while i < n_full:
        blevel = find_block_level(t, 0)
        R = _bucket_down(max(1, min(R, n_full - i)))
        t0 = time.perf_counter()
        memcpy_round = blevel < 0 or t.finish_memcpy
        if memcpy_round:
            if blevel == -2:
                t.finish_memcpy = True
            # memcpy rounds: COPY records, no device work. Each record is
            # its header and a view of the input, so the frame's join is
            # the one copy of its bytes: a memcpy rescue late in the budget
            # costs that one pass over the rest of the input
            for j in range(i, i + R):
                chunk = data[j * sb : (j + 1) * sb]
                if dst_size - pos < len(chunk) + 4:
                    raise StenosError(ERROR_DST_OVERFLOW)
                out += (bytes([METHOD_COPY])
                        + len(chunk).to_bytes(3, "little"),
                        memoryview(np.ascontiguousarray(chunk)))
                pos += 4 + len(chunk)
                t.processed_bytes += len(chunk)
        else:
            batch = data[i * sb : (i + R) * sb]
            pre = engine.encode_batch(batch, bpp, sb, block_level=blevel)
            for j in range(R):
                chunk = batch[j * sb : (j + 1) * sb]
                blob = compress_superblock_timed(
                    ctx, chunk, bpp, dst_size - pos, engine,
                    precomputed=pre[j], blevel_override=blevel)
                t.processed_bytes += len(chunk)
                out.append(blob)
                pos += len(blob)
        dt = max(time.perf_counter() - t0, 1e-6)
        if not memcpy_round:
            recent.append((R * sb) / dt)
            if len(recent) > 4:
                recent.pop(0)
        i += R
        rem_t = max((t.nanoseconds - t.elapsed()) * 1e-9, 0.0)
        R = next_round_size(recent, rem_t, sb)
    if nbytes > n_full * sb:
        chunk = data[n_full * sb :]
        blob = compress_superblock_timed(ctx, chunk, bpp, dst_size - pos,
                                         engine)
        t.processed_bytes += len(chunk)
        out.append(blob)
        pos += len(blob)
    return out


def compress(data, bytesoftype: int, level: int = 1, dst_size=None,
             engine=None, custom_shift=None, entropy=None, threads: int = 1,
             device=None, mesh=None) -> bytes:
    """stenos_compress equivalent. data: bytes / 1D uint8 array.

    engine: None = numpy host path; a TorchEngine = the device path;
    "auto" = a TorchEngine on "cuda" for inputs of AUTO_COMPRESS_BYTES and
    more (it raises when there is no card), the host path below.
    entropy: None = the zstd stage through libzstd; "device" = the device
    entropy coder on the engine's device, or without an engine on `device`
    ("cuda" unless given).
    threads: superblocks compressed on that many host threads (see below).
    mesh: a DeviceMesh or ProcessGroup of torch.distributed routes the
    whole compress through the sharded path (parallel/api.py,
    compress_sharded, on this rank's `device`, else the current CUDA
    device), before engine=, threads=, dst_size= and custom_shift= are
    looked at: collective, every rank passes the same data and gets the
    single-device frame.
    """
    if mesh is not None:
        from .parallel.api import compress_sharded

        return compress_sharded(data, bytesoftype, level, mesh,
                                entropy=entropy, device=device)
    _check_entropy(entropy)
    if engine == "auto":
        engine = _auto_engine(len(data), AUTO_COMPRESS_BYTES)
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    nbytes = len(data)
    level = min(9, max(0, level))
    if bytesoftype == 0 or bytesoftype >= MAX_BYTESOFTYPE:
        raise StenosError(ERROR_INVALID_BYTESOFTYPE)
    sb, shift = _superblock_params(bytesoftype, nbytes, level, custom_shift)
    if dst_size is None:
        if custom_shift is None or custom_shift == NO_BLOCK_SHIFT:
            # exactly stenos_bound: method selection is capacity-sensitive
            # at the margins, so parity requires the same default capacity
            dst_size = compress_bound(nbytes)
        else:
            # compress_bound assumes >= 65792-byte superblocks; small custom
            # blocksizes need the per-superblock overhead accounted exactly
            dst_size = 12 + max(1, -(-nbytes // sb)) * 4 + nbytes
    header = bytes([shift]) + nbytes.to_bytes(7, "little")
    if shift == 255:
        header += sb.to_bytes(4, "little")
    if len(header) > dst_size:
        raise StenosError(ERROR_DST_OVERFLOW)
    if nbytes == 0:
        return header

    # Batched device pre-pass: the engine encodes every full superblock's
    # block stream; the per-superblock loop then only does method selection.
    pre = None
    if engine is not None and level != 0:
        pre = engine.encode_batch(data, bytesoftype, sb)

    # Level-1 LZ hash table persists across the WHOLE frame: single-threaded
    # the reference's stack slot survives between block_compress calls at
    # level 1 (no estimator runs in between, stenos.cpp:449-450). At level
    # >= 2 lz4_guess_ratio scribbles the slot before every superblock, so
    # scope stays per superblock there (encode_full_blocks' fresh table).
    lz_tab = None
    if level == 1 and bytesoftype > 1:
        from .codec.lz_np import fresh_table

        lz_tab = fresh_table()

    out = [header]
    pos = len(header)
    if threads > 1 and level != 0 and nbytes > sb:
        # Host-thread fan-out (stenos.cpp:909-1016): each superblock
        # compresses into its own buffer with capacity sb + 4 (the
        # reference's per-thread CBuffer size), the frame's capacity checked
        # on join. Each superblock gets a fresh LZ table, like a reference
        # thread's fresh stack (level 1's frame-scoped table is
        # sequential), so the frame is the JAX package's threaded frame and
        # may differ from the 1-thread one; both decode the same. The pool
        # threads do host work only (LZ patch-up, method selection,
        # libzstd): the encode kernel ran in the pre-pass above, and a
        # superblock it did not cover (the partial tail) is compressed on
        # this thread meanwhile.
        def one(i):
            chunk = data[i * sb : (i + 1) * sb]
            return compress_superblock(
                chunk, bytesoftype, level, len(chunk) + 4, engine,
                precomputed=None if pre is None else pre[i], entropy=entropy,
                device=device)

        n_sb = -(-nbytes // sb)
        with trace.span("stn.superblocks", nbytes=nbytes, superblocks=n_sb), \
                ThreadPoolExecutor(max_workers=threads) as ex:
            futs = [None if pre is not None and pre[i] is None
                    else ex.submit(one, i) for i in range(n_sb)]
            here = {i: one(i) for i, f in enumerate(futs) if f is None}
            blobs = [here[i] if f is None else f.result()
                     for i, f in enumerate(futs)]
        for blob in blobs:
            pos += len(blob)
            if pos > dst_size:
                raise StenosError(ERROR_DST_OVERFLOW)
        with trace.span("stn.join", nbytes=pos):
            return b"".join(out + blobs)
    with trace.span("stn.superblocks", nbytes=nbytes,
                    superblocks=-(-nbytes // sb)):
        for i, off in enumerate(range(0, nbytes, sb)):
            chunk = data[off : off + sb]
            blob = compress_superblock(
                chunk, bytesoftype, level, dst_size - pos, engine,
                precomputed=None if pre is None else pre[i], entropy=entropy,
                lz_table=lz_tab, device=device)
            out.append(blob)
            pos += len(blob)
    with trace.span("stn.join", nbytes=pos):
        return b"".join(out)


def get_info(frame, bytesoftype: int):
    """stenos_get_info: (decompressed_size, superblock_size, header_len)."""
    frame = bytes(frame[:12])
    if len(frame) < 8:
        raise StenosError(ERROR_SRC_OVERFLOW)
    shift = frame[0]
    if shift > 4 and shift != 255:
        raise StenosError(ERROR_INVALID_INPUT)
    dsize = int.from_bytes(frame[1:8], "little")
    if shift == 255:
        if len(frame) < 12:
            raise StenosError(ERROR_SRC_OVERFLOW)
        sb = int.from_bytes(frame[8:12], "little")
        return dsize, sb, 12
    return dsize, super_block_size(bytesoftype * 256) << shift, 8


def _block_decode(payload, bpp, dsize):
    """Block-stream decode on the host: the native decoder."""
    from .native import load

    return load().block_decode(bytes(memoryview(np.asarray(payload))), bpp,
                               dsize)


def _zstd_decompress(payload, dsize):
    r = zstd_host.decompress(payload, dsize)
    if r is None:
        raise StenosError(ERROR_INVALID_INPUT)
    return np.frombuffer(r, np.uint8)


def _untranspose(code, r, bpp, dsize):
    """The un-delta and un-shuffle of a transposed zstd payload's bytes."""
    if len(r) != dsize:
        raise StenosError(ERROR_INVALID_INPUT)
    if code == METHOD_TRANSPOSED_DELTA_ZSTD:
        r = delta_inv_np(r)
    return unshuffle_np(r, bpp)


_ZSTD_METHODS = (METHOD_ZSTD, METHOD_TRANSPOSED_ZSTD,
                 METHOD_TRANSPOSED_DELTA_ZSTD)


class _Batcher:
    """Superblocks of a frame gathered up to CHUNK_BYTES of output a batch
    for the device. A batch's host pass (_prepare, on the host-pass thread
    of host/staging.py) runs while the batch before it decodes (_finish): at
    most two batches are in flight, and they finish in frame order."""

    def __init__(self):
        from .engine import CHUNK_BYTES

        self.limit = CHUNK_BYTES
        self.items, self.nbytes = [], 0
        self.pending = None  # (items, the future of their host pass)

    def add(self, item, dsize):
        """One superblock of dsize bytes."""
        if self.items and self.nbytes + dsize > self.limit:
            self._start()
        self.items.append(item)
        self.nbytes += dsize

    def _start(self):
        """Start the gathered batch's host pass on a thread (its span a
        child of this thread's), then finish the batch before it."""
        items, self.items, self.nbytes = self.items, [], 0
        fut = staging.host_pass.submit(self._host_pass, items,
                                       trace.current())
        prev, self.pending = self.pending, (items, fut)
        if prev:
            try:
                self._finish(*prev)
            except BaseException:
                self.pending = None
                wait([fut])  # the started host pass ends before the error
                raise

    def flush(self):
        """Finish everything gathered, in frame order: the first corrupt
        superblock raises."""
        if self.items:
            self._start()
        prev, self.pending = self.pending, None
        if prev:
            self._finish(*prev)

    def _host_pass(self, items, parent):
        with trace.span("stn.host_pass", parent=parent,
                        superblocks=len(items)):
            return self._prepare(items)


class _ZstdChunk(_Batcher):
    """The zstd superblocks of a frame, batched for the device decode
    (entropy/device_decode.py): a batch's host pass is prepare, and it
    comes back in one device-to-host copy and is written into out."""

    def __init__(self, device, bpp, frame, out):
        super().__init__()
        self.bpp, self.frame, self.out = bpp, frame, out
        self.device = torch.device(device)
        self.stage = staging.Staging(self.device)

    def _prepare(self, items):
        from .entropy.device_decode import prepare

        p0, p1 = items[0][1], items[-1][1] + items[-1][2]
        buf = np.zeros(max(4, -(-(p1 - p0) // 4) * 4), np.uint8)
        buf[: p1 - p0] = self.frame[p0:p1]
        dsizes = [it[3] for it in items]
        return buf, dsizes, prepare(buf, [it[1] - p0 for it in items],
                                    [it[2] for it in items], dsizes)

    def _host_buffer(self, dev_out):
        """dev_out's bytes on the host (through a pinned buffer on CUDA)."""
        if dev_out.device.type != "cuda":
            return dev_out.numpy()
        h = self.stage.get("output", dev_out.numel())
        h.copy_(dev_out)
        return h.numpy()

    def _finish(self, items, fut):
        from .entropy.device_decode import decode_prepared, settle, step

        dev = self.device
        with step("host_pass", dev):  # the part not hidden behind the last
            buf, dsizes, prepared = fut.result()
        dev_out = torch.empty(sum(dsizes), dtype=torch.uint8, device=dev)
        ok = decode_prepared(buf, dsizes, prepared, dev_out, self.stage)
        with step("d2h_output", dev):
            host = self._host_buffer(dev_out) if any(ok) else None
        settle()
        with step("frame_out", dev):
            offs = np.cumsum([0] + dsizes[:-1]).tolist()
            # device-decoded METHOD_ZSTD: copied out by runs
            for run in staging.runs([
                    (w, o, d) for (code, _, _, d, w), o, good
                    in zip(items, offs, ok) if good and code == METHOD_ZSTD]):
                staging.put(self.out, run, host)
            for (code, pos, csize, dsize, written), o, good in zip(
                    items, offs, ok):
                if good and code == METHOD_ZSTD:
                    continue
                r = (host[o : o + dsize] if good else _zstd_decompress(
                    self.frame[pos : pos + csize], dsize))
                if code != METHOD_ZSTD:
                    r = _untranspose(code, r, self.bpp, dsize)
                if len(r) != dsize:
                    raise StenosError(ERROR_INVALID_INPUT)
                self.out[written : written + dsize] = r


class _BlockChunk(_Batcher):
    """The full-size METHOD_BLOCK and METHOD_BLOCK_ZSTD superblocks of a
    frame, batched for the decode kernel. A batch's host pass
    (engine.prepare_blocks: host libzstd on the residuals, the native row
    parse) fills one of two sets of host buffers (pinned on a CUDA device),
    once the upload from that set has run; the batch goes to the device and
    decodes with one kernel launch (TorchEngine.decode_blocks). Then a sink
    takes it. out, a uint8 array, is the host sink: the batch comes back
    into one of two output buffers, from which threads copy it into out
    while the next batch decodes, and a superblock that does not unpack or
    parse takes the host path, as decompress_superblock: its error, or its
    bytes, after the batch's superblocks before it are written. out=None is
    the device sink: each batch's decoded tensor stays on the device, in
    outs, and a superblock that does not unpack or parse raises
    StenosError."""

    def __init__(self, engine, bpp, sb, frame, out):
        super().__init__()
        self.engine, self.bpp, self.sb = engine, bpp, sb
        self.frame = np.ascontiguousarray(frame)
        self.out = out
        self.outs = []  # the device sink's tensors, one a batch
        self.bufs = [staging.Staging(engine.device),
                     staging.Staging(engine.device)]
        self.hosts = [staging.Staging(engine.device),
                      staging.Staging(engine.device)]
        self.copy = None  # the copy into out that runs

    def _prepare(self, items):
        from .engine import prepare_blocks

        bufs = self.bufs[0]
        self.bufs.reverse()
        if bufs.uploaded is not None:
            with trace.span("stn.upload_wait"):
                bufs.uploaded.synchronize()
        return bufs, prepare_blocks(self.frame, items, self.bpp, self.sb,
                                    bufs)

    def flush(self):
        """Finish everything gathered; every copy into out has ended when
        it returns or raises."""
        try:
            super().flush()
        finally:
            self._copied()

    def _finish(self, items, fut):
        with trace.span("stn.prep_wait") as wait:
            bufs, prep = fut.result()
        prep["times"]["wait_ms"] = wait.host_ms
        self._decode(items, bufs, prep)

    def _copied(self):
        """Wait for the copy into out that runs."""
        if self.copy is not None:
            copy, self.copy = self.copy, None
            copy.result()

    def _decode(self, items, bufs, prep):
        from . import engine

        n, sb = prep["n_ok"], self.sb
        if n:
            host = None if self.out is None else self.hosts[0]
            dec = self.engine.decode_blocks(prep, self.bpp, sb, bufs, host)
            if self.out is None:
                self.outs.append(dec)
            else:
                self._copy_out(items[:n], dec, prep["times"])
            if engine.timing is not None:
                engine.timing.append({"superblocks": n,
                                      "times": prep["times"]})
        if n < len(items):
            if self.out is None:
                raise StenosError(ERROR_INVALID_INPUT)
            code, pos, csize, w = items[n]
            r = decompress_superblock(code, self.frame[pos : pos + csize],
                                      self.bpp, sb)
            if len(r) != sb:
                raise StenosError(ERROR_INVALID_INPUT)
            self.out[w : w + sb] = r
            rest = items[n + 1 :]
            if rest:
                self._decode(rest, bufs, engine.prepare_blocks(
                    self.frame, rest, self.bpp, sb, bufs))

    def _copy_out(self, items, host, times):
        """The host sink: host's batch into out on the output-copy thread,
        once the batch before's copy (from the other buffer) has ended."""
        self.hosts.reverse()
        runs = staging.runs([(w, i * self.sb, self.sb)
                             for i, (_, _, _, w) in enumerate(items)])
        with trace.span("stn.out_wait") as wait:
            self._copied()  # the batch before: its buffer is the next
        times["out_wait_ms"] = wait.host_ms
        n = len(items)

        def copy(parent):
            with trace.span("stn.out_copy", parent=parent,
                            nbytes=n * self.sb, superblocks=n) as c:
                for run in runs:
                    staging.put(self.out, run, host)
            times["out_ms"] = c.host_ms

        self.copy = staging.out_copy.submit(copy, trace.current())


def _zstd_payload(payload, dsize, engine):
    """A zstd payload's bytes: on the engine's device when it has one
    (entropy/device_decode.py; host libzstd takes a payload whose headers
    the device decode hands back, as decompress does), else host libzstd."""
    if engine is not None:
        from .entropy.device_decode import decode_payload_device

        with engine.lock:
            r = decode_payload_device(bytes(memoryview(np.asarray(payload))),
                                      dsize, engine.device)
            if r is not None:
                return r.cpu().numpy()
    return _zstd_decompress(payload, dsize)


def decompress_superblock(code, payload, bpp, dsize, engine=None):
    """decompress_generic_superblock (stenos.cpp:681-753). engine: None =
    the host path; a TorchEngine decodes a block stream with one launch of
    the decode kernel (decode_block_stream) and a zstd payload on its
    device."""
    if code in (METHOD_BLOCK, METHOD_BLOCK_ZSTD):
        if code == METHOD_BLOCK_ZSTD:
            payload = _zstd_decompress(payload, MAX_BLOCK_BYTES)
        r = (engine.decode_block_stream(payload, bpp, dsize)
             if engine is not None else _block_decode(payload, bpp, dsize))
        if isinstance(r, int):
            raise StenosError(ERROR_INVALID_INPUT)
        return r
    if code == METHOD_ZSTD:
        return _zstd_payload(payload, dsize, engine)
    if code in (METHOD_TRANSPOSED_ZSTD, METHOD_TRANSPOSED_DELTA_ZSTD):
        return _untranspose(code, _zstd_payload(payload, dsize, engine), bpp,
                            dsize)
    if code == METHOD_COPY:
        if dsize != len(payload):
            raise StenosError(ERROR_INVALID_INPUT)
        return np.frombuffer(bytes(payload), np.uint8)
    raise StenosError(ERROR_INVALID_INPUT)


def decompress(frame, bytesoftype: int, dst_size=None, engine=None,
               mesh=None, device=None):
    """stenos_decompress equivalent -> uint8 array.

    mesh: a DeviceMesh or ProcessGroup of torch.distributed fans the decode
    out over its ranks (parallel/api.py, decompress_sharded, on this rank's
    `device`, else the current CUDA device), before engine= is looked at:
    collective, every rank passes the same frame. `device` is read only
    with a mesh.

    engine: None = host path; "auto" = a TorchEngine on "cuda" for frames
    of AUTO_DECOMPRESS_BYTES and more (it raises when there is no card),
    the host path below; a TorchEngine gathers the frame's full-size
    METHOD_BLOCK and METHOD_BLOCK_ZSTD superblocks CHUNK_BYTES at a time
    into one launch of the decode kernel each (_BlockChunk) and its zstd
    superblocks CHUNK_BYTES at a time into the device zstd decode
    (_ZstdChunk); COPY superblocks and a partial tail take the host path.
    Errors come in frame order, as the host path's. Unlike the reference
    (stenos.cpp:1131 latent bug), inputs whose size is an exact multiple of
    the superblock size decode correctly.
    """
    if bytesoftype == 0 or bytesoftype >= MAX_BYTESOFTYPE:
        raise StenosError(ERROR_INVALID_BYTESOFTYPE)
    if mesh is not None:
        from .parallel.api import decompress_sharded

        r = decompress_sharded(frame, bytesoftype, mesh, device=device)
        if dst_size is not None and len(r) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        return r
    frame = np.frombuffer(bytes(frame), np.uint8) if not isinstance(
        frame, np.ndarray) else frame
    if engine == "auto":
        engine = _auto_engine(len(frame), AUTO_DECOMPRESS_BYTES)
    dsize_total, sb, hlen = get_info(frame[:12].tobytes(), bytesoftype)
    if dst_size is not None and dsize_total > dst_size:
        raise StenosError(ERROR_DST_OVERFLOW)
    if dsize_total == 0:
        return np.zeros(0, np.uint8)

    n = len(frame)
    pos = hlen
    out = np.empty(dsize_total, np.uint8)
    chunk = blocks = None
    if engine is not None:
        chunk = _ZstdChunk(engine.device, bytesoftype, frame, out)
        if sb % (256 * bytesoftype) == 0:
            blocks = _BlockChunk(engine, bytesoftype, sb, frame, out)

    def flush():  # the gathered superblocks, each batcher's errors in order
        err = None
        for g in (blocks, chunk):
            try:
                if g is not None:
                    g.flush()
            except StenosError as e:
                err = err or e
        if err is not None:
            raise err

    def fail(code):  # the superblocks gathered before raise first
        flush()
        raise StenosError(code)

    written = 0
    while written < dsize_total:
        if pos + 4 > n:
            fail(ERROR_SRC_OVERFLOW)
        code = int(frame[pos])
        csize = int.from_bytes(frame[pos + 1 : pos + 4].tobytes(), "little")
        pos += 4
        dsize = min(sb, dsize_total - written)
        if pos + csize > n:
            fail(ERROR_INVALID_INPUT)
        try:
            if chunk is not None and code in _ZSTD_METHODS:
                chunk.add((code, pos, csize, dsize, written), dsize)
            elif (blocks is not None and dsize == sb
                  and code in (METHOD_BLOCK, METHOD_BLOCK_ZSTD)):
                blocks.add((code, pos, csize, written), dsize)
            else:
                r = decompress_superblock(code, frame[pos : pos + csize],
                                          bytesoftype, dsize)
                if len(r) != dsize:
                    raise StenosError(ERROR_INVALID_INPUT)
                out[written : written + dsize] = r
        except StenosError as e:  # a batcher's raises for an earlier one
            fail(e.code)
        written += dsize
        pos += csize
    flush()
    return out
