#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json] [--old-src DIR]

Builds the encode_blocks, decode_rows, huff_encode, huff_decode, fse_encode,
seq_decode and seq_exec kernels from stenos_tpu_torch/csrc (and the native
host runtime), holds each kernel -- encode_blocks (K1), its index mode
encode_blocks_index (K1b), decode_rows (K2), its derive mode
decode_rows_derive (K2b), huff_histogram (K3), huff_encode_streams (K4),
huff_decode_streams (K5), fse_encode (K6), seq_decode (K7) and seq_exec (X1)
-- against its plain torch version on the card, checks 32 MiB frames byte for byte against the
numpy host path, holds compress_frames_device (a batch of frames, one K1
launch) against its plain version on a grid of bpp, frames and superblocks
a frame and against compress_frame_device on the image-u16 cell's images,
timing one batched call beside a call an image (phase_frames, with K1's
registers and spills by ptxas), then drives the main path -- compress / decompress of 512
MiB of sorted int32 (bytesoftype 4) at levels 1 and 2, each decompress
exactly one K2 launch a 64 MiB batch, then a second decompress split by
step (host pass, copies, K2, copy into the output) -- and the
context phase (phase_context) on the same 512 MiB: time-limited
compress_generic after Context.warmup at 25%, 100% and 400% of this run's
level-1 compress time (each within 1.35x + 250 ms of its budget, decoded
exactly), compress_generic without a limit (the level-1 frame), threads=1
and 4 at levels 1 and 2, engine="auto" at 1, 4 and 16 MiB (the route and
both routes' times) and CompressedArray on 64 MiB at block_shift=4 and 4
MiB at block_shift=0 (build, to_numpy, 10,000 reads, serialize() equal to
the host path's; a K1 and a K2 launch a chunk); then the sharded paths
(phase_sharding): a world of 1 over NCCL on the same 512 MiB --
compress(mesh=) at levels 1 and 2 and compress_device_sharded (ragged and
gathered) equal to the single-device frames, decompress(mesh=) exact in
one K2 launch, each timed beside the single-device path -- and two gloo
ranks (subprocesses of this script, --gloo-rank) on this one card on 64
MiB, their results equal to this process's single-device ones; then the
device-resident paths on the same 512 MiB: roundtrip_device,
DeviceCompressedArray (build, reads, serialize, deserialize) and
compress_frame_device; compress_frame_device on 1-D float64 columns with
every kind of end (phase_column: each frame the host path's, launches,
short-superblock counters; a day's column against the 2-D frame of its
whole superblocks, K1 and encode_short by events); the device frame's one
K1 launch (phase_fold: K1 places every record by a decoupled look-back)
against the plain version and against K1's records placed by the public
place_records, byte for byte over the capacity, at bpp 1-16 and 1 to
16,384 superblocks, on 55 column lengths and over 200 calls back to back,
every frame on dirtied memory; K1's launch descriptors over 200 calls back
to back that change key at every call, one under a side stream
(phase_launch: one build a key, 3 device allocations a frame-mode call);
K2 and K2b timed at
their paths' shapes beside their bounds; then DeviceCompressedArray(entropy=True) on 512 MiB of a
low-cardinality byte column (K4 and K5 timed at its build's, to_array's and
one slab read's shapes) and on the sorted int32; then the device
zstd entropy stage (phase_zstd): a grid of payloads and the 512 MiB text
cell (code text, bpp 1, level 2) compressed through libzstd and through
compress(entropy="device"), both decompressed on the card, and K6 on the
cell's sequences (K5 timed on a text chunk, K6 on 64 blocks); then the
parity grid (phase_grid: tools/validate_cuda.py's closed loop and frame grid
on a subset, each frame against the host path's and decoded both ways,
decompress_frame_batched(keep_device=True) of the 512 MiB level-1 frame,
eight batches, held against the data and timed beside decompress) and the entropy frames'
options (phase_entropy_frames: encode_frame_device(sidecar=False) and
STENOS_SEQ_ANCHORS=0, decoded on the card and by host libzstd). It holds each
kernel against its plain version again at the shapes those paths give it,
times the kernels with CUDA events and prints the kernels' JSON line. With
--old-src (a checkout of an earlier commit), that commit's K2/K2b, K4, K5
and K6 are timed beside these on the same inputs, in turns, and must give
the same outputs; so are its device frame compress (sorted int32 and a
day's float64 column: the launch path's host split by step, each call
waited for as the benchmark's cells do, and its device allocations), K1
streams launch, K1b and place_records (phase_launch_times). Any failure
ends the run with a non-zero exit code. The last line is {"ok": true,
"device": {...}}.
"""

import argparse
import hashlib
import importlib.util
import itertools
import json
import os
import re
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

import stenos_tpu_torch as stt
from stenos_tpu_torch import device_container
from stenos_tpu_torch import parallel as par
from stenos_tpu_torch import engine as eng
from stenos_tpu_torch import frame as fr
from stenos_tpu_torch import native
from stenos_tpu_torch.host import staging
from stenos_tpu_torch.host import zstd as zstd_host
from stenos_tpu_torch.device_container import record_blocks
from stenos_tpu_torch.engine import (CHUNK_BYTES, compress_frame_device,
                                     compress_frames_device,
                                     frame_header_bytes, roundtrip_device)
from stenos_tpu_torch.entropy import (device_decode, fse_kernel,
                                      huff_decode_kernel, huff_kernel,
                                      seq_exec, seqdec_kernel, zstd_frame)
from stenos_tpu_torch.entropy.huff_decode_kernel import decode_tables
from stenos_tpu_torch.entropy.huff_kernel import BLOCK, STREAM
from stenos_tpu_torch.entropy.huffman import luts_batch
from stenos_tpu_torch.entropy.match_device import match_candidates
from stenos_tpu_torch.entropy.sequences import FRESH_REPS, encode_sequences
from stenos_tpu_torch.ops import _cuda, decode_kernel, encode_kernel
from stenos_tpu_torch.ops.encode_kernel import frames_stride, record_bound
from stenos_tpu_torch.utils import trace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# 32-bit integer instructions a second: 132 SMs x 64 lanes a clock (the
# CUDA C++ Programming Guide's throughput table, compute capability 9.0:
# add, compare, min/max, logical and shift ops) x the 1.98 GHz boost clock
# (H100 SXM data sheet)
INT_OPS_PER_S = 132 * 64 * 1.98e9
# integer instructions an input byte that the encode cannot do without: the
# per-element body of analyse() in csrc/encode_blocks.cu (load, sign
# extensions, delta, two repeat-mask bits, the two running min/max pairs);
# plane decisions and emission come on top
ENCODE_OPS_PER_BYTE = 11
# integer instructions an output byte that the decode cannot do without: the
# per-element body of csrc/decode_rows.cu (unpack shift and mask, the min or
# the running sum, the carry, the store); the records come on top
DECODE_OPS_PER_BYTE = 5
CLOCK_HZ = 1.98e9  # H100 SXM boost clock (data sheet)
MIB = 1024 * 1024
HEADLINE_MB = 512  # bench.py's headline size
TEXT_MB = 512  # the text cell: 4096 superblocks of 128 KiB
CONTAINER_MB = 64  # CompressedArray at block_shift=4: 4096 chunks of 16 KiB
CONTAINER_READS = 10_000  # random element reads of each container
GLOO_MB = 64  # phase_sharding's two gloo ranks on one card
GLOO_SEED = 11
GLOO_TIMEOUT_S = 300
TEXT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchs",
                         "data", "code_text.txt")
KINDS = ("sorted", "random", "same", "rle", "smallrange")
# bpp of the small grid: the encode's tiling changes at 5, 16, 17, 32 and 64
# (blocks a tile, plane groups above 64)
GRID_BPP = (1, 2, 3, 4, 5, 8, 16, 17, 24, 32, 64, 300)
DIRTY_SMALL = 64  # 2 MiB segments of small blocks dirty_block fills
# the folded frame's grid (phase_fold): bpp, and superblocks a frame around
# one wave of K1 (132 SMs x 4 resident CTAs = 528) and well past it
FOLD_BPP = (1, 2, 3, 4, 8, 16)
FOLD_N_SB = (1, 2, 527, 528, 529, 4096, 16384)
# the batches of frames' grid (phase_frames): bpp, frames a batch, and
# superblocks a frame (17 x 32 frames reach past one wave of K1)
FRAMES_BPP = (1, 2, 4, 8, 16)
FRAMES_F = (1, 2, 32)
FRAMES_PER = (1, 17, 64)
IMAGES = 32  # the image-u16 cell's batch: 32 images of 8 MiB
IMAGE_BYTES = 8 * MIB


def load_tool(name):
    """A module of tools/ (not a package) by its path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the sweep: its grid and closed loop, and the data generators it shares
vc = load_tool("validate_cuda")
gen_elements, sorted_int32 = vc.gen_elements, vc.sorted_int32


def low_card(rng, n):
    """The low-cardinality column of tests/test_device_container.py: uint8
    values 97..126 with p ~ 1/k."""
    p = 1.0 / np.arange(1, 31)
    return rng.choice(np.arange(97, 127, dtype=np.uint8), size=n,
                      p=p / p.sum())


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """A failed check ends the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def encode_bound(in_bytes, moved, rows_bytes):
    """The encode's bound: the larger of its bytes (moved: the input, the
    streams or records, the sizes) over the memory rate and its integer
    instructions over their rate. rows_bytes_ms counts the whole rows
    returned instead, the zeros after each stream or record included."""
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    o_ms = ENCODE_OPS_PER_BYTE * in_bytes / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": moved, "bytes_ms": b_ms, "ops_ms": o_ms,
            "rows_bytes_ms": (moved + rows_bytes) / HBM_BYTES_PER_S * 1e3}


def queued_ms(fn, reps):
    """Mean device time of fn() over reps calls queued behind a sleep
    kernel, by CUDA events: the card's time for the calls back to back, not
    the host's time to issue them (which sets cuda_ms of a small call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000 * reps)  # ~0.1 ms a call at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def decode_bound(moved, out_bytes):
    """The decode's bound: the larger of its bytes (moved: the stream bytes
    the index points into, the index, the decoded output) over the memory
    rate and its integer instructions over their rate."""
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    o_ms = DECODE_OPS_PER_BYTE * out_bytes / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bytes": moved, "bytes_ms": b_ms, "ops_ms": o_ms}


def encode_err(k, p):
    """Max abs difference of the kernel's and the plain version's encode
    outputs over each stream's first totals bytes; the sizes (and the index
    mode's plane_off) must agree."""
    for a, b in zip(k[1:], p[1:]):
        check(torch.equal(a, b), "encode sizes or plane_off differ from the "
              "plain version")
    w = min(k[0].shape[1], p[0].shape[1])
    valid = torch.arange(w, device=k[1].device) < k[1][:, None]
    d = (k[0][:, :w].int() - p[0][:, :w].int()).abs()[valid]
    return int(d.max()) if d.numel() else 0


def zeros_past(rows, totals):
    """Every byte of each row past its totals is zero."""
    past = (torch.arange(rows.shape[1], device=rows.device)
            >= totals[:, None])
    return not rows[past].any()


def dirty_block(nbytes, dev):
    """Fill nbytes of device memory with 0xFF and free them: with the
    allocator's other free blocks released first, it hands that block to the
    next tensor of the size, so a byte a kernel leaves unwritten there reads
    0xFF, not an earlier tensor's zero. The small blocks (K1's look-back
    state among them) come from 2 MiB segments of their own: DIRTY_SMALL
    of them are filled with 0xFF and freed too, so the next small tensors
    take dirtied memory as well. Returns the block's address (on the CPU,
    None)."""
    if dev.type != "cuda":
        return None
    torch.cuda.empty_cache()
    small = [torch.full((1 << 20,), 0xFF, dtype=torch.uint8, device=dev)
             for _ in range(2 * DIRTY_SMALL)]
    del small
    t = torch.full((nbytes,), 0xFF, dtype=torch.uint8, device=dev)
    return t.data_ptr()


def frame_on_dirty(fn, cap, dev, what):
    """(frame, length) = fn() with a dirtied block of the frame's capacity
    cap before it; checks that the frame took that block (on the card) and
    that every byte past its length is zero."""
    ptr = dirty_block(cap, dev)
    frame, length = fn()
    check(frame.numel() == cap and (ptr is None or frame.data_ptr() == ptr),
          ("the frame did not take the dirtied block", *what))
    check(not frame[int(length):].any(), ("frame padding", *what))
    return frame, length


def decode_err(k, p):
    check(k.shape == p.shape, "decode shape differs from the plain version")
    return int((k.int() - p.int()).abs().max())


KERNEL_COUNTS = ((encode_kernel, "launches", "encode_blocks"),
                 (encode_kernel, "launches_index", "encode_blocks_index"),
                 (decode_kernel, "launches", "decode_rows"),
                 (decode_kernel, "launches_derive", "decode_rows_derive"),
                 (huff_kernel, "launches_histogram", "huff_histogram"),
                 (huff_kernel, "launches_encode", "huff_encode_streams"),
                 (huff_decode_kernel, "launches", "huff_decode_streams"),
                 (fse_kernel, "launches", "fse_encode"),
                 (seqdec_kernel, "launches", "seq_decode"),
                 (seq_exec, "launches", "seq_exec"))
# the kernels' launches and, counted apart, the frame-mode K1 launches
# (each zeroes a frame's capacity and places its own records; also in
# encode_blocks), the launches for a batch of frames (also in
# encode_blocks) and encode_short's
COUNTS = KERNEL_COUNTS + ((encode_kernel, "launches_frame_placed",
                           "frame_placed"),
                          (encode_kernel, "launches_frames", "frames"),
                          (encode_kernel, "launches_short", "encode_short"))
SOURCES = ("encode_blocks", "decode_rows", "huff_encode", "huff_decode",
           "fse_encode", "seq_decode", "seq_exec")


def reset_counts():
    torch.cuda.synchronize()
    for mod, attr, _ in COUNTS:
        setattr(mod, attr, 0)


def read_counts():
    torch.cuda.synchronize()
    return {name: getattr(mod, attr) for mod, attr, name in COUNTS}


def block_streams(frame, bpp):
    """(sb, [block stream bytes]) of the frame's BLOCK / BLOCK_ZSTD records
    over full superblocks."""
    dsize, sb, pos = fr.get_info(frame, bpp)
    out = []
    for _ in range(dsize // sb):
        code = frame[pos]
        csize = int.from_bytes(frame[pos + 1 : pos + 4], "little")
        payload = frame[pos + 4 : pos + 4 + csize]
        if code == 1:
            out.append(payload)
        elif code == 5:
            stream = zstd_host.decompress(payload, 1 << 24)
            check(stream is not None, "BLOCK_ZSTD payload")
            out.append(stream)
        pos += 4 + csize
    return sb, out


def parsed_index(streams, bpp, sb):
    """Row index of concatenated block streams (native parse_rows_batch)."""
    buf = b"".join(streams)
    offs = np.cumsum([0] + [len(s) for s in streams[:-1]])
    r = native.load().parse_rows_batch(buf, bpp, sb, offs,
                                       [len(s) for s in streams],
                                       max(len(s) for s in streams) + 32)
    check(not isinstance(r, int), f"parse_rows_batch failed: {r}")
    return r


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        host = ex.submit(native.load)
        _cuda.build(SOURCES)
        host.result()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc x{len(SOURCES)} + "
        "g++, in parallel)")
    for name in SOURCES:
        with open(os.path.join(_cuda.BUILD_DIR, f"{name}.ptxas.txt")) as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    log(f"  ptxas {name}: {line.strip()}")
    return card


def phase_kernels(dev):
    """Each kernel against its plain version on the card, byte for byte."""
    rng = np.random.default_rng(2024)
    err = {name: 0 for _, _, name in KERNEL_COUNTS}

    def record(name, e, what):
        err[name] = max(err[name], e)
        check(err[name] == 0, (name, *what))

    n = 0
    for bpp, n_sb, kind in itertools.product(
            GRID_BPP, (3, 1), KINDS):
        sb = fr.super_block_size(256 * bpp)
        nb = sb // (256 * bpp)
        raw = gen_elements(rng, bpp, n_sb * sb // bpp, kind)
        x = torch.from_numpy(raw.copy()).to(dev).view(n_sb, sb)
        for level in (0, 1, 2):
            k = encode_kernel.encode_superblocks(x, bpp, level)
            p = encode_kernel.encode_superblocks_plain(x, bpp, level)
            record("encode_blocks", encode_err(k, p), (bpp, kind, level))
            hdr = frame_header_bytes(n_sb * sb, sb, bpp, 1)
            cap = len(hdr) + n_sb * record_bound(nb, bpp)
            reset_counts()
            k = frame_on_dirty(lambda: encode_kernel.encode_superblocks_frame(
                x, bpp, level, hdr), cap, dev, (bpp, kind, level))
            c = read_counts()
            check((c["encode_blocks"], c["frame_placed"]) == (1, 1),
                  ("frame launches", bpp, kind, level, c))
            p = encode_kernel.encode_superblocks_frame_plain(x, bpp, level,
                                                             hdr)
            check(int(k[1]) == int(p[1]), ("frame length", bpp, kind, level))
            record("encode_blocks", decode_err(k[0], p[0]),
                   (bpp, kind, level, "frame"))
            # the public place_records, which zeroes the tail itself
            rows, totals = encode_kernel.encode_superblocks_records(
                x, bpp, level)[:2]
            q = frame_on_dirty(lambda: encode_kernel.place_records(
                rows, totals - 4, hdr, nb, bpp), cap, dev,
                (bpp, kind, level, "place_records"))
            check(int(q[1]) == int(p[1]) and torch.equal(q[0], k[0]),
                  ("place_records frame", bpp, kind, level))

            p = encode_kernel.encode_superblocks_index_plain(x, bpp, level)
            for width in (None, record_bound(nb, bpp)):
                k = encode_kernel.encode_superblocks_index(x, bpp, level,
                                                           width)
                record("encode_blocks_index", encode_err(k, p),
                       (bpp, kind, level, width))
                check(zeros_past(k[0], k[1]), ("index rows padding", bpp,
                                               kind, level, width))
            out = decode_kernel.decode_rows_derive(k[0], k[4], bpp, nb, "jb")
            record("decode_rows_derive", decode_err(
                out, decode_kernel.decode_rows_derive_plain(
                    k[0], k[4], bpp, nb, "jb")), (bpp, kind, level, "jb"))
            check(torch.equal(out.view(n_sb, sb), x),
                  ("derive jb round trip", bpp, kind, level))
            if level == 0:  # no frame level encodes at block level 0
                continue

            frame = fr.compress(raw, bpp, level, engine=None)
            sbs, streams = block_streams(frame, bpp)
            if not streams:
                continue
            vb, po, rt, _ = parsed_index(streams, bpp, sbs)
            args = [torch.from_numpy(a).to(dev) for a in (vb, po, rt)]
            nbs = sbs // (256 * bpp)
            record("decode_rows", decode_err(
                decode_kernel.decode_rows(*args, bpp, nbs),
                decode_kernel.decode_rows_plain(*args, bpp, nbs)),
                (bpp, kind, level))
            out = decode_kernel.decode_rows_derive(args[0], args[1], bpp, nbs,
                                                   "bj")
            record("decode_rows_derive", decode_err(
                out, decode_kernel.decode_rows_derive_plain(
                    args[0], args[1], bpp, nbs, "bj")),
                (bpp, kind, level, "bj"))
            check(torch.equal(out, decode_kernel.decode_rows(*args, bpp, nbs)),
                  ("derive bj == explicit records", bpp, kind, level))
            # a corrupt index pointing near the row's end reads zeros there
            bad = args[1].clone()
            bad[:, -1] = (bad[:, -1] & ~0xFFFFFF) | (args[0].shape[1] - 3)
            record("decode_rows_derive", decode_err(
                decode_kernel.decode_rows_derive(args[0], bad, bpp, nbs, "bj"),
                decode_kernel.decode_rows_derive_plain(args[0], bad, bpp, nbs,
                                                       "bj")),
                (bpp, kind, level, "corrupt index"))
            n += 1
    log(f"kernels == plain versions on the card: {n} decode cases over bpp "
        f"{GRID_BPP} x 3 and 1 superblocks x 5 kinds x levels 1,2; the "
        "encodes also at block level 0: encode_blocks as streams and as a "
        "frame (one launch, records placed by K1; and place_records alone; "
        "both frames on a dirtied block, zeros past the length), "
        "encode_blocks_index at the longest "
        "record's width and at "
        "record_bound (zeros past every record), "
        "decode_rows_derive in 'jb' and 'bj' order")
    huff_grid(rng, dev, record)
    fse_grid(rng, dev, record)
    log(f"max abs err on the card: {err}")
    return err


def huff_streams(rng, kind, ns):
    """ns Huffman streams of one kind of data."""
    if kind == "normal":
        a = rng.normal(128, 20, ns * STREAM).clip(0, 255)
    elif kind == "two":
        a = rng.choice([3, 250], ns * STREAM, p=[0.9, 0.1])
    elif kind == "deep":  # counts halving over 21 symbols: 11-bit codes
        reps = np.maximum((ns * 8192) >> np.arange(21), 1)
        a = np.repeat(np.arange(21) * 7, reps)[: ns * STREAM]
        a = rng.permutation(np.concatenate([a,
                                            np.zeros(ns * STREAM - len(a))]))
    elif kind == "one":
        a = np.full(ns * STREAM, 42)
    elif kind == "lowcard":
        a = low_card(rng, ns * STREAM)
    else:
        a = rng.integers(0, 256, ns * STREAM)
    return np.asarray(a, np.uint8).reshape(ns, STREAM)


def huff_err(k, p):
    """Max abs difference of two tuples of equal-shaped integer tensors."""
    for a, b in zip(k, p):
        check(a.shape == b.shape and a.dtype == b.dtype,
              "Huffman kernel output's shape or type differs from the plain "
              "version's")
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(k, p))


def huff_grid(rng, dev, record):
    """K3, K4 and K5 against their plain versions: 6 kinds of data x 1 and
    3 blocks; K5 on rows cut to the store's 512-byte bucket and on whole
    rows, and on corrupt anchors (reads past the row)."""
    n = 0
    for kind, nblk in itertools.product(
            ("normal", "two", "deep", "one", "lowcard", "uniform"), (1, 3)):
        x = torch.from_numpy(huff_streams(rng, kind, 4 * nblk)).to(dev)
        blocks = x.view(nblk, BLOCK)
        hist = huff_kernel.histogram(blocks)
        record("huff_histogram", huff_err(
            (hist,), (huff_kernel.histogram_plain(blocks),)), (kind, nblk))
        lens, luts = luts_batch(hist.cpu().numpy())
        lut = torch.from_numpy(np.repeat(luts, 4, axis=0)).to(dev)
        enc = huff_kernel.encode_streams(x, lut, with_anchors=True)
        record("huff_encode_streams", huff_err(
            enc, huff_kernel.encode_streams_plain(x, lut, with_anchors=True)),
            (kind, nblk))
        words, sizes, anchors = enc
        tabs = torch.from_numpy(np.repeat(decode_tables(lens), 4,
                                          axis=0)).to(dev)
        wbucket = -(-int(sizes.max()) // 512) * 512
        for w in (wbucket // 4, words.shape[1]):
            rows = words[:, :w].contiguous().view(torch.uint8)
            out = huff_decode_kernel.decode_streams(rows, anchors, tabs)
            record("huff_decode_streams", huff_err(
                (out,), (huff_decode_kernel.decode_streams_plain(
                    rows, anchors, tabs),)), (kind, nblk, w))
            check(torch.equal(out, x), ("Huffman round trip", kind, nblk, w))
        bad = torch.randint(0, 400_000, anchors.shape, dtype=torch.int32,
                            device=dev)
        record("huff_decode_streams", huff_err(
            (huff_decode_kernel.decode_streams(rows, bad, tabs),),
            (huff_decode_kernel.decode_streams_plain(rows, bad, tabs),)),
            (kind, nblk, "corrupt anchors"))
        n += 1
    log(f"Huffman kernels == plain versions on the card: {n} cases over 6 "
        "kinds x 1 and 3 blocks; decode on bucket and whole rows and on "
        "corrupt anchors; decode(encode(x)) == x")


def fse_seqs(rng, n):
    """n random sequences (ll, offset value, ml) as an (n, 3) array."""
    return np.stack([rng.integers(0, 20, n), rng.integers(1, 60000, n) + 3,
                     rng.integers(3, 200, n)], 1)


def no_sync_seqs(n):
    """n sequences (an (n, 3) array) whose LL, ML and OF codes each take
    four values in turn: uniform counts, so no code is a sync point and K6
    walks each channel serially."""
    i = np.arange(n)
    return np.stack([i % 4, 16 << (i % 4), 3 + (i * 3) % 4], 1)


def fse_grid(rng, dev, record):
    """K6 (the launch, encode_bitstreams_cuda) against its plain version on
    blocks built on the card: a block whose three channels have no sync
    point (no_sync_seqs), an all-RLE block, one sequence, 20 sequences
    (the predefined tables), and a block of 40,000 sequences (past 0x7F00:
    the long nseq header; a zstd block holds at most 43,690), in one batch;
    then a small batch with one block's word_cap a word short (bits -1 and
    its first word_cap words; the wrapper raises RuntimeError), a table
    whose state leaves its range and a block over the kernel's 49,152
    sequences (the kernel's -2: the wrapper raises ValueError)."""
    blocks = {
        "no_sync": (no_sync_seqs(5000), FRESH_REPS),
        "rle": (np.tile([[7, 64 + 3, 40]], (3000, 1)), (64, 4, 8)),
        "one": (np.array([[5, 1003, 30]]), FRESH_REPS),
        "predefined": (fse_seqs(rng, 20), FRESH_REPS),
        "long": (fse_seqs(rng, 40_000), FRESH_REPS)}
    preps = {k: fse_kernel.prep_block(sq, reps)[1]
             for k, (sq, reps) in blocks.items()}
    args = fse_kernel.pack_blocks(list(preps.values()), dev)
    sync = fse_kernel.sync_states(args[1], args[2])
    rows = preps["no_sync"]["seqs"]
    ns = list(preps).index("no_sync")
    check(all(int((sync[ns, ch][torch.from_numpy(rows[:, ch]).to(dev).long()]
                   >= 0).sum()) == 0 for ch in range(3)),
          "the no-sync block has a sync point")
    k = fse_kernel.encode_bitstreams_cuda(*args)
    p = fse_kernel.encode_bitstreams_plain(*args)
    check(bool((k[1] > 0).all()), f"K6 grid bits {k[1].tolist()}")
    record("fse_encode", huff_err(k, p), ("grid", list(preps)))
    # one block a word short
    small = [preps[n] for n in ("no_sync", "rle", "one", "predefined")]
    seqs, tabs, meta = fse_kernel.pack_blocks(small, dev)
    need = (fse_kernel.encode_bitstreams_plain(seqs, tabs, meta)[1] + 31) // 32
    cap = meta[:, 3].clone()
    cap[0] = need[0] - 1
    short = meta.clone()
    short[:, 3] = cap
    short[:, 2] = torch.cumsum(cap, 0) - cap
    k = fse_kernel.encode_bitstreams_cuda(seqs, tabs, short)
    p = fse_kernel.encode_bitstreams_plain(seqs, tabs, short)
    check(k[1][0].item() == -1 and bool((k[1][1:] > 0).all()),
          f"K6 capacity report: {k[1].tolist()}")
    record("fse_encode", huff_err(k, p), ("a block a word short",))
    try:
        fse_kernel.encode_bitstreams(seqs, tabs, short)
        check(False, "K6's wrapper took a block over its word_cap")
    except RuntimeError as e:
        check("word room" in str(e), f"K6 capacity: {e}")
    # the RLE block's LL state table set to 5: its state leaves [0, 0]
    bad = tabs.clone()
    bad[1, 0, 2 * fse_kernel.NSYM] = 5
    check(fse_kernel.encode_bitstreams_plain(seqs, bad, meta)[1].min() > 0,
          "the plain version of the bad table")
    check(fse_kernel.encode_bitstreams_cuda(seqs, bad, meta)[1][1].item()
          == -2, "K6 did not report the bad table's block")
    try:
        fse_kernel.encode_bitstreams(seqs, bad, meta)
        check(False, "K6 took a state out of its range")
    except ValueError as e:
        check("range" in str(e), f"K6 bad table: {e}")
    over = fse_kernel.pack_blocks(
        [fse_kernel.prep_block(fse_seqs(rng, 49_153), FRESH_REPS)[1],
         preps["one"]], dev)
    b = fse_kernel.encode_bitstreams_cuda(*over)[1].tolist()
    check(b[0] == -2 and b[1] > 0, f"K6 over 49,152 sequences: bits {b}")
    try:
        fse_kernel.encode_bitstreams(*over)
        check(False, "K6 took a block over 49,152 sequences")
    except ValueError as e:
        check("49,152" in str(e), f"K6 long block: {e}")
    log("K6 == plain version on the card: no sync point, RLE, one sequence, "
        "predefined tables, 40,000 sequences; a block a word short (-1, the "
        "wrapper raises); a state out of range and a block of 49,153 "
        "sequences (-2, the wrapper raises)")


def phase_host_frames(dev):
    raw = sorted_int32(32 * MIB, seed=7)
    for level in (1, 2):
        want = fr.compress(raw, 4, level, engine=None)
        got = stt.compress(raw, 4, level, device=dev)
        check(got == want, f"32 MiB level {level}: frame differs from host")
        back = stt.decompress(got, 4, device=dev)
        check(np.array_equal(back, raw), f"32 MiB level {level}: round trip")
    log("32 MiB sorted int32, levels 1 and 2: frames == host path, "
        "round trip ok")


def image_u16(dev, n, nbytes=IMAGE_BYTES, seed=2**31 + 29):
    """n images of the benchmark's image-u16 configuration, made on the
    card by its own generator: (n, nbytes) uint8."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "portbench", "configs", "image-u16.py")
    spec = importlib.util.spec_from_file_location("image_u16_gen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return torch.stack([mod.make(seed, i, nbytes, dev) for i in range(n)])


def plain_frames(x, bpp, hdr, n_frames):
    """The batch of frames of (n_frames * per, sb) x by the plain version
    on the card (its records in slices; each frame in its row behind the
    header, zeros to the row's stride): (out, [lengths])."""
    nb = x.shape[1] // (256 * bpp)
    per = x.shape[0] // n_frames
    rows, totals = in_chunks(
        lambda a: encode_kernel.encode_superblocks_index_plain(
            a, bpp, 2, record_bound(nb, bpp))[:2], (x,))
    out = torch.zeros((n_frames, frames_stride(per, nb, bpp, len(hdr))),
                      dtype=torch.uint8, device=x.device)
    keep = torch.arange(rows.shape[1], device=x.device)
    lengths = []
    for f in range(n_frames):
        r, t = rows[f * per : (f + 1) * per], totals[f * per : (f + 1) * per]
        body = r[keep < t[:, None]]
        out[f, : len(hdr)] = torch.tensor(list(hdr), dtype=torch.uint8)
        out[f, len(hdr) : len(hdr) + body.numel()] = body
        lengths.append(len(hdr) + body.numel())
    return out, lengths


def k1_ptxas():
    """ptxas's report of encode_blocks: {function: {"registers", "stores",
    "loads"}} for each encode_superblocks instantiation and each function
    of K1's look-back and placement that was not inlined."""
    res, entry, props = {}, None, None

    def ours(name):
        return (res.setdefault(name, {}) if re.search(
            "encode_superblocks|look_back|place", name) else None)

    with open(os.path.join(_cuda.BUILD_DIR, "encode_blocks.ptxas.txt")) as f:
        for ln in f:
            name = (ln.split("'")[1] if "'" in ln
                    else ln.split()[-1].strip())
            used = re.search(r"Used (\d+) registers", ln)
            if "Compiling entry function" in ln:
                entry = ours(name)
            elif "Function properties for" in ln:
                props = ours(name)
            elif props is not None and "spill stores" in ln:
                for n, k in re.findall(r"(\d+) bytes spill (stores|loads)",
                                       ln):
                    props[k] = int(n)
            elif entry is not None and used:
                entry["registers"] = int(used.group(1))
    return res


def phase_frames(dev):
    """compress_frames_device: a batch of frames in one launch of K1's
    batch instantiation. The grid FRAMES_BPP x FRAMES_F frames x FRAMES_PER
    superblocks a frame (fold_data) against the plain version on the card,
    byte for byte over each row's stride, on a dirtied block: one K1 launch
    (counted in encode_blocks and frames) a call, frames_batched counting
    frames; F = 1 against compress_frame_device. Then the image-u16 cell's
    batch (32 images of 8 MiB, its own generator): each row equals
    compress_frame_device's frame of its image, 50 calls back to back over
    two batches equal each batch's first, the span stn.compress_frames_device
    has events and stn.k1.launch as its child, and 32 compress_frame_device
    calls (one an image) and one compress_frames_device call are timed in
    turns by CUDA events (as issued back to back, and queued behind a sleep
    kernel: the card's time alone). K1's four instantiations: 64 registers,
    no spills (ptxas)."""
    res = {"grid": 0}
    sb = 131072
    for bpp in FRAMES_BPP:
        nb = sb // (256 * bpp)
        for n_frames in FRAMES_F:
            for per in FRAMES_PER:
                what = ("frames", bpp, n_frames, per)
                x = fold_data(dev, bpp, n_frames * per, sb)
                hdr = frame_header_bytes(per * sb, sb, bpp, 1)
                stride = frames_stride(per, nb, bpp, len(hdr))
                ptr = dirty_block(n_frames * stride, dev)
                reset_counts()
                b0 = eng.frames_batched
                out, lengths = compress_frames_device(
                    x.view(n_frames, per * sb), bpp, 1)
                c = read_counts()
                check((c["encode_blocks"], c["frames"], c["frame_placed"])
                      == (1, 1, 0) and eng.frames_batched - b0 == n_frames,
                      (*what, "launches", c))
                check(out.shape == (n_frames, stride)
                      and (ptr is None or out.data_ptr() == ptr),
                      (*what, "the batch did not take the dirtied block"))
                want, n = plain_frames(x, bpp, hdr, n_frames)
                check(lengths.tolist() == n and torch.equal(out, want),
                      (*what, "differs from the plain version"))
                if n_frames == 1:
                    one, n1 = compress_frame_device(x, bpp, 1)
                    check(int(n1) == n[0]
                          and torch.equal(out[0, : one.numel()], one),
                          (*what, "differs from compress_frame_device"))
                del x, out, want
                res["grid"] += 1
    log(f"batches of frames == the plain version over each row's stride, "
        f"on dirtied blocks: bpp {FRAMES_BPP} x {FRAMES_F} frames x "
        f"{FRAMES_PER} superblocks a frame, one K1 launch a batch")

    imgs = [image_u16(dev, IMAGES, seed=2**31 + 29 + k) for k in range(2)]
    per = IMAGE_BYTES // sb
    firsts = []
    for batch in imgs:
        out, lengths = compress_frames_device(batch, 2, 1)
        n = lengths.tolist()
        for i in range(IMAGES):
            one, n1 = compress_frame_device(batch[i].view(per, sb), 2, 1)
            check(int(n1) == n[i] and torch.equal(out[i, : one.numel()], one)
                  and not out[i, one.numel():].any(),
                  ("image", i, "differs from compress_frame_device"))
        firsts.append((out, n))
    res["ratio"] = sum(firsts[0][1]) / (IMAGES * IMAGE_BYTES)
    torch.cuda.synchronize()
    outs = [compress_frames_device(imgs[i % 2], 2, 1) for i in range(50)]
    torch.cuda.synchronize()
    for i, (out, lengths) in enumerate(outs):
        check(lengths.tolist() == firsts[i % 2][1]
              and torch.equal(out, firsts[i % 2][0]),
              ("back to back", i, "differs from its batch's first"))
    del outs
    log(f"{IMAGES} image-u16 images of 8 MiB: each row == "
        f"compress_frame_device of its image (ratio {res['ratio']:.4f}); "
        "50 batches back to back == each batch's first")

    eng.timing = []
    compress_frames_device(imgs[0], 2, 1)
    torch.cuda.synchronize()
    spans = trace.records()
    top_ms = trace.report()["spans"]
    eng.timing = None
    top = [s for s in spans if s.name == "stn.compress_frames_device"]
    k1 = [s for s in spans if s.name == "stn.k1.launch"]
    check(len(top) == 1 and len(k1) == 1 and k1[0].parent == top[0].id
          and top[0].frames == IMAGES and top[0].events is not None,
          "the span stn.compress_frames_device, its events and its K1 child")
    res["span"] = {
        "device_ms": top_ms["stn.compress_frames_device"]["device_ms"],
        "k1_device_ms": top_ms["stn.k1.launch"]["device_ms"],
        "host_ms": top_ms["stn.compress_frames_device"]["host_ms"]}

    batch = imgs[0]
    fns = {"per_image": lambda: [compress_frame_device(
               batch[i].view(per, sb), 2, 1) for i in range(IMAGES)],
           "batched": lambda: compress_frames_device(batch, 2, 1)}
    times = {k: {"ms": [], "queued_ms": []} for k in fns}
    for who in ("per_image", "batched", "batched", "per_image") * 2:
        times[who]["ms"].append(cuda_ms(fns[who], 20))
        times[who]["queued_ms"].append(queued_ms(fns[who], 20))
    res["times"] = {k: {m: sorted(v)[len(v) // 2] for m, v in t.items()}
                    | {"all_" + m: v for m, v in t.items()}
                    for k, t in times.items()}
    for k, t in res["times"].items():
        t["ms_per_image"] = t["ms"] / IMAGES
        t["queued_ms_per_image"] = t["queued_ms"] / IMAGES
    log(f"{IMAGES} images of 8 MiB, ms a batch (as issued / queued): one "
        f"call an image {res['times']['per_image']['ms']:.4f} / "
        f"{res['times']['per_image']['queued_ms']:.4f}, one batched call "
        f"{res['times']['batched']['ms']:.4f} / "
        f"{res['times']['batched']['queued_ms']:.4f}")
    del imgs, batch, fns, firsts

    res["ptxas"] = k1_ptxas()
    entries = {k: v for k, v in res["ptxas"].items()
               if "encode_superblocks" in k}
    log(f"ptxas K1: {res['ptxas']}")
    check(len(entries) == 4, ("K1 instantiations in ptxas", entries))
    for name, v in res["ptxas"].items():
        check(v.get("stores", 0) == 0 and v.get("loads", 0) == 0
              and (name not in entries or v.get("registers", 99) <= 64),
              ("K1 registers or spills", name, v))
    torch.cuda.empty_cache()
    return res


def phase_headline(dev):
    """The main path at each level, with the launch counts set to 0 just
    before it and read just after."""
    raw = sorted_int32(HEADLINE_MB * MIB)
    res = {}
    nchunk = -(-HEADLINE_MB * MIB // CHUNK_BYTES)
    for level in (1, 2):
        reset_counts()
        t0 = time.perf_counter()
        frame = stt.compress(raw, 4, level, device=dev)
        t1 = time.perf_counter()
        back = stt.decompress(frame, 4, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(np.array_equal(back, raw), f"headline level {level} round trip")
        res[level] = {
            "frame": frame,
            "ratio": len(raw) / len(frame),
            "compress_gbps": len(raw) / (t1 - t0) / 1e9,
            "decompress_gbps": len(raw) / (t2 - t1) / 1e9,
            "compress_s": t1 - t0,
            "decompress_s": t2 - t1,
            "launches": read_counts(),
        }
        r = res[level]
        check(r["launches"]["encode_blocks"]
              and r["launches"]["decode_rows"] == nchunk,
              f"level {level}: a kernel did not run, or the decompress did "
              f"not make one K2 launch a {CHUNK_BYTES // MIB} MiB batch: "
              f"{r['launches']}")
        log(f"headline {HEADLINE_MB} MiB sorted int32 level {level}: ratio "
            f"{r['ratio']:.4f}, compress {r['compress_s']:.3f} s = "
            f"{r['compress_gbps']:.4f} GB/s, decompress {r['decompress_s']:.3f}"
            f" s = {r['decompress_gbps']:.4f} GB/s, launches {r['launches']}")
        # the split: a second decompress with each batch's steps timed
        eng.timing = []
        t0 = time.perf_counter()
        back = stt.decompress(frame, 4, device=dev)
        t1 = time.perf_counter()
        chunks, eng.timing = eng.timing, None
        check(np.array_equal(back, raw) and len(chunks) == nchunk,
              f"headline level {level}: the timed decompress")
        del back
        r["split"] = decompress_split(chunks, t1 - t0)
        log(f"  split of a second decompress ({len(chunks)} batches), ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["split"].items()
                        if not isinstance(v, list)))
    return raw, res


def decompress_split(chunks, total_s):
    """Sums over the batches of a timed decompress (engine.timing): the
    host pass on its thread (prep_ms: unpack_ms + parse_ms) and the part of
    it the decode waited for (wait_ms), so hid behind the batch before
    (hidden_prep_ms); the copies and K2 by CUDA events; the copy into the
    output on its threads (out_ms) and the part of it the next batch waited
    for (out_wait_ms), so hid (hidden_out_ms); each batch's too."""
    keys = ("unpack_ms", "parse_ms", "wait_ms", "h2d_ms", "k2_ms", "d2h_ms",
            "out_wait_ms", "out_ms")
    split = {k: sum(c["times"].get(k, 0.0) for c in chunks) for k in keys}
    split["prep_ms"] = split["unpack_ms"] + split["parse_ms"]
    split["hidden_prep_ms"] = split["prep_ms"] - split["wait_ms"]
    split["hidden_out_ms"] = split["out_ms"] - split["out_wait_ms"]
    split["total_ms"] = total_s * 1e3
    split["rest_ms"] = split["total_ms"] - sum(
        split[k] for k in ("wait_ms", "h2d_ms", "k2_ms", "d2h_ms",
                           "out_wait_ms"))
    split["per_batch"] = [{"superblocks": c["superblocks"], **c["times"]}
                          for c in chunks]
    return split


def phase_timing(dev, raw, frame1, frame2):
    """K1 and K2 against their plain versions at the shapes the main path
    gives them: one CHUNK_BYTES call of 128 KiB superblocks (encode, level-1
    and level-2 decode) and one superblock; K1 timed there with its
    transfers, the plain K2 and the native parse of a batch on one thread
    (phase_decode_times times K2)."""
    sb = fr.super_block_size(1024)
    per_call = CHUNK_BYTES // sb
    chunk = raw[: per_call * sb]
    host = torch.from_numpy(chunk.copy()).view(per_call, sb)
    x = host.to(dev)
    out = {}
    enc = encode_kernel.encode_superblocks(x, 4, 2)
    err = {"encode_blocks": encode_err(
        enc, encode_kernel.encode_superblocks_plain(x, 4, 2))}
    check(err["encode_blocks"] == 0, "encode at the main path's shape")
    k_ms = cuda_ms(lambda: encode_kernel.encode_superblocks(x, 4, 2), 10)
    # the launch alone, without the wrapper's read of the longest stream
    rb = record_bound(sb // 1024, 4)
    launch_ms = cuda_ms(lambda: encode_kernel._encode_rows(
        x, 4, 2, rb - 4, 0, False), 10)
    p_ms = cuda_ms(lambda: encode_kernel.encode_superblocks_plain(x, 4, 2), 2)
    # the input, the streams, the sizes
    stream_bytes = int(enc[1].sum())
    moved = (x.numel() + stream_bytes + 4 * (enc[2].numel() + enc[3].numel()
                                             + per_call))
    out["encode_blocks"] = {
        "ms": k_ms, "launch_ms": launch_ms,
        "plain_ms": p_ms,
        **encode_bound(x.numel(), moved, enc[0].numel() - stream_bytes)}
    h2d = cuda_ms(lambda: host.to(dev), 5)
    d2h = cuda_ms(lambda: enc[0].cpu(), 5)
    out["encode_blocks"].update(h2d_ms=h2d, d2h_ms=d2h,
                                streams_bytes=enc[0].numel())

    sbs, streams = block_streams(frame1, 4)
    streams = streams[:per_call]
    t0 = time.perf_counter()
    vb, po, rt, _ = parsed_index(streams, 4, sbs)
    parse_s = time.perf_counter() - t0
    args = [torch.from_numpy(a).to(dev) for a in (vb, po, rt)]
    nb = sbs // 1024
    err["decode_rows"] = decode_err(decode_kernel.decode_rows(*args, 4, nb),
                                    decode_kernel.decode_rows_plain(*args, 4,
                                                                    nb))
    # a level-2 batch (the BLOCK_ZSTD residuals), and one superblock alone
    s2 = block_streams(frame2, 4)[1]
    for batch in (s2[:per_call], s2[:1], streams[:1]):
        a2 = [torch.from_numpy(a).to(dev)
              for a in parsed_index(batch, 4, sbs)[:3]]
        err["decode_rows"] = max(err["decode_rows"], decode_err(
            decode_kernel.decode_rows(*a2, 4, nb),
            decode_kernel.decode_rows_plain(*a2, 4, nb)))
    check(err["decode_rows"] == 0, "decode at the main path's shapes")
    p_ms = cuda_ms(lambda: decode_kernel.decode_rows_plain(*args, 4, nb), 2)
    out["decode_rows"] = {"plain_ms": p_ms,
                          "parse_one_thread_ms": parse_s * 1e3}
    for name, t in out.items():
        log(f"{name} at {len(chunk) // MIB} MiB: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    log(f"kernels == plain versions at the main path's shapes: {err}")
    return out, err


def timed_s(fn):
    """(fn(), its host wall time in s, the card synchronized after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def median_s(fn, n=3):
    """(fn()'s last result, the median of n host wall times in s)."""
    runs = [timed_s(fn) for _ in range(n)]
    return runs[-1][0], float(np.median([t for _, t in runs]))


def filled(v, vals):
    """The container v after v.extend(vals)."""
    v.extend(vals)
    return v


class Rounds:
    """Counts an engine's encode_batch calls (the timed rounds that encode;
    memcpy rounds make none) by wrapping the instance's method."""

    def __init__(self, engine):
        self.n, real = 0, engine.encode_batch

        def count(*a, **k):
            self.n += 1
            return real(*a, **k)

        engine.encode_batch = count


def phase_context(dev, raw, frame1, level1_s):
    """This slice's entry points on the card, each path with the launch
    counts set to 0 just before it and read just after: (a) time-limited
    compress_generic of the headline's 512 MiB after Context.warmup, at
    25%, 100% and 400% of the untimed level-1 compress time of this run
    (level1_s), each within 1.35x + 250 ms of its budget and decoded
    exactly; (b) compress_generic without a limit, equal to the headline's
    level-1 frame; (c) threads=1 and threads=4 at levels 1 and 2, the
    threaded frames decoded exactly; (d) engine="auto" at 1, 4 and 16 MiB:
    the route it takes, and compress and decompress on the host path and
    on the card; (e) CompressedArray on CONTAINER_MB of sorted int32 at
    block_shift=4 and on 1 Mi elements at block_shift=0: build, to_numpy,
    CONTAINER_READS random reads, serialize() equal to the host-path
    container's, each chunk one K1 launch to encode and one K2 launch to
    decode; K1 and K2 held against their plain versions on a chunk."""
    res = {"launches": {}}
    err = {"encode_blocks": 0, "decode_rows": 0}

    # (a) time-limited compress
    t0 = time.perf_counter()
    stt.Context(max_nanoseconds=1).warmup(4, len(raw),
                                          block_levels=(0, 1, 2))
    res["warmup_s"] = time.perf_counter() - t0
    timed_res = res["timed"] = {}
    for pct in (25, 100, 400):
        budget_ns = int(level1_s * pct / 100 * 1e9)
        ctx = stt.Context(max_nanoseconds=budget_ns)
        rounds = Rounds(ctx.engine)
        reset_counts()
        t0 = time.perf_counter_ns()
        frame = stt.compress_generic(ctx, raw, 4)
        elapsed = time.perf_counter_ns() - t0
        lc = read_counts()
        reset_counts()
        back, dec_s = timed_s(lambda: stt.decompress(frame, 4, device=dev))
        ld = read_counts()
        exact = bool(np.array_equal(back, raw))
        del back
        bound_ns = budget_ns * 1.35 + 250_000_000
        r = timed_res[f"{pct}%"] = {
            "budget_ms": budget_ns / 1e6, "elapsed_ms": elapsed / 1e6,
            "overshoot_ms": (elapsed - budget_ns) / 1e6,
            "bound_ms": bound_ns / 1e6, "encode_rounds": rounds.n,
            "ratio": len(raw) / len(frame), "round_trip_exact": exact,
            "unsatisfiable": ctx.t.unsatisfiable,
            "decompress_s": dec_s, "launches": lc, "decompress_launches": ld}
        res["launches"][f"timed_{pct}"] = lc
        res["launches"][f"timed_{pct}_decompress"] = ld
        log(f"timed {len(raw) // MIB} MiB at {pct}% of level 1's "
            f"{level1_s * 1e3:.1f} ms: budget {r['budget_ms']:.1f} ms, "
            f"elapsed {r['elapsed_ms']:.1f} ms (overshoot "
            f"{r['overshoot_ms']:.1f}, bound {r['bound_ms']:.1f}), "
            f"{rounds.n} encode rounds, K1 x{lc['encode_blocks']}, ratio "
            f"{r['ratio']:.4f}, round trip {'exact' if exact else 'WRONG'}")
        check(exact, f"timed {pct}%: round trip")
        check(elapsed < bound_ns, f"timed {pct}%: {elapsed / 1e6:.1f} ms "
              f"past the bound of {bound_ns / 1e6:.1f} ms")
        del frame

    # (b) compress_generic without a limit
    reset_counts()
    f, s = timed_s(lambda: stt.compress_generic(stt.Context(level=1), raw, 4))
    res["launches"]["generic"] = read_counts()
    check(f == frame1, "compress_generic differs from compress")
    res["generic_s"] = s
    log(f"compress_generic, no limit: {s:.3f} s, frame == compress's")
    del f

    # (c) threads
    thr = res["threads"] = {}
    for level in (1, 2):
        for n in (1, 4):
            reset_counts()
            f, s = timed_s(lambda: stt.compress(raw, 4, level, threads=n))
            lc = read_counts()
            back, ds = timed_s(lambda: stt.decompress(f, 4))
            exact = bool(np.array_equal(back, raw))
            del back
            thr[f"level{level}_threads{n}"] = {
                "compress_s": s, "compress_gbps": len(raw) / s / 1e9,
                "ratio": len(raw) / len(f), "decompress_s": ds,
                "round_trip_exact": exact, "launches": lc}
            res["launches"][f"threads{n}_level{level}"] = lc
            log(f"threads={n} level {level}: compress {s:.3f} s = "
                f"{len(raw) / s / 1e9:.4f} GB/s, ratio "
                f"{len(raw) / len(f):.4f}, round trip "
                f"{'exact' if exact else 'WRONG'}")
            check(exact, f"threads={n} level {level}: round trip")
            del f

    # (d) engine="auto": the route, and both routes' times (the card's and
    # the decompresses' the median of 3, in turns)
    auto = res["auto"] = {}
    for mb in (1, 4, 16):
        data = raw[: mb * MIB]
        host_f, hc = timed_s(lambda: stt.compress(data, 4, 1, engine=None))
        card_f, cc = median_s(lambda: stt.compress(data, 4, 1, device=dev))
        reset_counts()
        auto_f, ac = timed_s(lambda: stt.compress(data, 4, 1, engine="auto"))
        c_route = "card" if read_counts()["encode_blocks"] else "host"
        check(host_f == card_f == auto_f, f"auto {mb} MiB: frames differ")
        hd, cd = [], []
        for _ in range(3):
            hd.append(timed_s(lambda: stt.decompress(host_f, 4,
                                                     engine=None))[1])
            cd.append(timed_s(lambda: stt.decompress(host_f, 4,
                                                     device=dev))[1])
        hd, cd = float(np.median(hd)), float(np.median(cd))
        reset_counts()
        back, ad = timed_s(lambda: stt.decompress(host_f, 4, engine="auto"))
        d_route = "card" if read_counts()["decode_rows"] else "host"
        check(np.array_equal(back, data), f"auto {mb} MiB: round trip")
        auto[f"{mb}MiB"] = {
            "frame_bytes": len(host_f), "compress_route": c_route,
            "decompress_route": d_route, "compress_host_s": hc,
            "compress_card_s": cc, "compress_auto_s": ac,
            "decompress_host_s": hd, "decompress_card_s": cd,
            "decompress_auto_s": ad}
        log(f"auto {mb} MiB: compress -> {c_route} (host {hc * 1e3:.1f} ms, "
            f"card {cc * 1e3:.1f} ms), decompress of {len(host_f)} B -> "
            f"{d_route} (host {hd * 1e3:.1f} ms, card {cd * 1e3:.1f} ms)")

    # (e) CompressedArray
    cont = res["container"] = {}
    rng = np.random.default_rng(5)
    for name, shift, nbytes in (("shift4", 4, CONTAINER_MB * MIB),
                                ("shift0", 0, 4 * MIB)):
        vals = raw[:nbytes].view(np.int32)
        c = {"elements": len(vals), "block_shift": shift}
        reset_counts()
        v, c["build_s"] = timed_s(lambda: filled(
            stt.CompressedArray(np.int32, block_shift=shift), vals))
        c["launches_build"] = lb = read_counts()
        res["launches"][f"container_{name}_build"] = lb
        c["chunks"] = len(v._buckets)
        reset_counts()
        out, c["to_numpy_s"] = timed_s(v.to_numpy)
        c["launches_to_numpy"] = lt = read_counts()
        res["launches"][f"container_{name}_to_numpy"] = lt
        check(np.array_equal(out, vals), f"container {name}: to_numpy")
        idx = rng.integers(0, len(vals), CONTAINER_READS)
        reset_counts()
        got, c["reads_s"] = timed_s(lambda: [v[int(i)] for i in idx])
        c["launches_reads"] = lr = read_counts()
        res["launches"][f"container_{name}_reads"] = lr
        check(np.array_equal(np.array(got, np.int32), vals[idx]),
              f"container {name}: random reads")
        reset_counts()
        blob, c["serialize_s"] = timed_s(v.serialize)
        res["launches"][f"container_{name}_serialize"] = read_counts()
        host, c["host_build_serialize_s"] = timed_s(lambda: filled(
            stt.CompressedArray(np.int32, block_shift=shift, engine=None),
            vals).serialize())
        check(blob == host, f"container {name}: serialize() differs from "
              "the host path's")
        c["serialize_bytes"] = len(blob)
        c["ratio"] = vals.nbytes / len(blob)
        check(lb["encode_blocks"] > 0 and lt["decode_rows"] > 0
              and lr["decode_rows"] > 0, f"container {name}: K1 or K2 did "
              f"not run: {lb} {lt} {lr}")
        # one chunk: K1 and K2 against their plain versions, and the cost
        # of a chunk through the engine (host clock, median of 50)
        chunk = np.ascontiguousarray(vals[: v.chunk_elems]).view(np.uint8)
        x = torch.from_numpy(chunk.copy()).to(dev).view(1, -1)
        err["encode_blocks"] = max(err["encode_blocks"], encode_err(
            encode_kernel.encode_superblocks(x, 4, 2),
            encode_kernel.encode_superblocks_plain(x, 4, 2)))
        rec = v._buckets[0].compressed
        check(rec[0] == 1, "container chunk 0 is not METHOD_BLOCK")
        vb, po, rt, _ = native.load().parse_rows(rec[4:], 4, len(chunk))
        a = [torch.from_numpy(t).to(dev) for t in (vb, po, rt)]
        nb = len(chunk) // 1024
        err["decode_rows"] = max(err["decode_rows"], decode_err(
            decode_kernel.decode_rows(*a, 4, nb),
            decode_kernel.decode_rows_plain(*a, 4, nb)))
        e = v.engine
        enc, dec = [], []
        for _ in range(50):
            t0 = time.perf_counter()
            e.encode_block_stream(chunk, 4, len(chunk))
            t1 = time.perf_counter()
            e.decode_block_stream(rec[4:], 4, len(chunk))
            t2 = time.perf_counter()
            enc.append(t1 - t0)
            dec.append(t2 - t1)
        c["chunk_encode_ms"] = float(np.median(enc)) * 1e3
        c["chunk_decode_ms"] = float(np.median(dec)) * 1e3
        c["k1_chunk_ms"] = cuda_ms(
            lambda: encode_kernel.encode_superblocks(x, 4, 2), 20)
        c["k2_chunk_ms"] = queued_ms(
            lambda: decode_kernel.decode_rows(*a, 4, nb), 20)
        cont[name] = c
        log(f"container {name}: {len(vals)} int32 in {c['chunks']} chunks, "
            f"build {c['build_s']:.3f} s (K1 x{lb['encode_blocks']}), "
            f"to_numpy {c['to_numpy_s']:.3f} s (K2 x{lt['decode_rows']}), "
            f"{CONTAINER_READS} reads {c['reads_s']:.3f} s (K2 "
            f"x{lr['decode_rows']}), serialize() == host path's "
            f"(ratio {c['ratio']:.4f}; the host container "
            f"{c['host_build_serialize_s']:.3f} s); a chunk through the "
            f"engine: encode {c['chunk_encode_ms']:.3f} ms, decode "
            f"{c['chunk_decode_ms']:.3f} ms (K1 {c['k1_chunk_ms']:.4f}, K2 "
            f"{c['k2_chunk_ms']:.4f} ms on the card)")
        del v, out, blob, host
    check(max(err.values()) == 0, f"K1 or K2 differ from their plain "
          f"versions on a container chunk: {err}")
    return res, err


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def digest(b):
    return hashlib.sha256(bytes(memoryview(np.asarray(b)))).hexdigest()


def in_turns_s(fns, rounds=1, events=False):
    """Mean host wall times in s (timed_s: the card synchronized) of each
    of fns (name -> function), in turns (a, b, b, a, rounds times);
    events=True adds each one's mean time between CUDA events around the
    call, in s, under name + "_events"."""
    ts = {k: [] for k in fns} | ({k + "_events": [] for k in fns}
                                if events else {})
    for who in (list(fns) + list(fns)[::-1]) * rounds:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def call():
            ev[0].record()
            fns[who]()
            ev[1].record()

        ts[who].append(timed_s(call)[1])
        if events:
            ts[who + "_events"].append(ev[0].elapsed_time(ev[1]) / 1e3)
    return {k: sum(v) / len(v) for k, v in ts.items()}


def mesh_decode_args(frame, bpp, dev):
    """The args of the mesh decode's K2 launch at world 1: the native
    parse of every superblock of frame (all METHOD_BLOCK), on dev."""
    f = np.frombuffer(frame, np.uint8)
    found = eng._block_records(f, bpp)
    check(found is not None, "the mesh decode's frame is not all "
          "METHOD_BLOCK superblocks")
    sb, items = found
    prep = eng.prepare_blocks(f, items, bpp, sb, staging.Staging(dev))
    check(prep["n_ok"] == len(items), "native parse of the mesh decode")
    return [a.to(dev) for a in prep["args"]], sb // (256 * bpp)


def phase_sharding(dev, raw, frames, card):
    """The sharded paths (stenos_tpu_torch.parallel), each with the launch
    counts set to 0 just before it and read just after. (a) A world of 1
    over NCCL on the headline's 512 MiB: compress(mesh=) at levels 1 and 2
    (== the headline's frames), decompress(mesh=) of the level-1 frame
    (exact, one K2 launch) and of the level-2 frame (BLOCK_ZSTD: the
    single-device route, one K2 launch a 64 MiB batch),
    compress_device_sharded and the gathered variant (== the level-1
    frame, which is compress_frame_device's); each timed beside the
    single-device path, in turns; K1's records mode and the mesh decode's
    one K2 launch held against their plain versions. (b) Two gloo ranks in
    subprocesses, both on this card, on GLOO_MB of sorted int32: the same
    four checks against the single-device results of this process."""
    res = {"card": card, "launches": {}, "world1": {}, "gloo2": {}}
    err = {"encode_blocks": 0, "decode_rows": 0}
    sb = fr.super_block_size(1024)
    n_sb = len(raw) // sb
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = par.make_mesh()
        w1 = res["world1"]
        for level in (1, 2):
            reset_counts()
            got, s = timed_s(lambda: stt.compress(raw, 4, level, mesh=mesh))
            res["launches"][f"mesh level {level}"] = read_counts()
            check(got == frames[level], f"mesh level {level} compress "
                  "differs from the single-device frame")
            del got
            t = in_turns_s({
                "single": lambda: stt.compress(raw, 4, level, device=dev),
                "mesh": lambda: stt.compress(raw, 4, level, mesh=mesh)})
            w1[f"compress_{level}"] = {"first_s": s, **t}
        for level in (1, 2):
            reset_counts()
            back = stt.decompress(frames[level], 4, mesh=mesh)
            res["launches"][f"mesh decompress level {level}"] = read_counts()
            check(np.array_equal(back, raw), f"mesh decompress level {level}")
            del back
            w1[f"decompress_{level}"] = in_turns_s({
                "single": lambda: stt.decompress(frames[level], 4,
                                                 device=dev),
                "mesh": lambda: stt.decompress(frames[level], 4, mesh=mesh)})
        k2 = res["launches"]["mesh decompress level 1"]["decode_rows"]
        check(k2 == 1, f"mesh decompress: {k2} K2 launches, not one")
        for level in (1, 2):
            check(res["launches"][f"mesh level {level}"]["encode_blocks"],
                  f"mesh level {level} compress: K1 did not run (launches)")

        x = torch.from_numpy(raw.copy()).to(dev).view(n_sb, sb)
        for name, fn in (
                ("ragged", lambda: par.compress_device_sharded(x, 4, 1,
                                                               mesh)),
                ("gathered", lambda: par.compress_device_sharded_gathered(
                    x, 4, 1, mesh))):
            reset_counts()
            frame, length = fn()
            c = read_counts()
            res["launches"][f"mesh device frame {name}"] = c
            # the ragged segment: one frame-mode K1, which zeroes its tail
            # and places its records; the gathered variant: K1's records
            # mode, then place_records, which zeroes its own
            ragged = name == "ragged"
            check((c["encode_blocks"], c["frame_placed"])
                  == ((1, 1) if ragged else (2, 0)),
                  f"mesh device frame {name}: K1 launches {c}")
            check(frame[:length].cpu().numpy().tobytes() == frames[1],
                  f"compress_device_sharded ({name}) differs from "
                  "compress_frame_device")
            del frame
            w1[f"device_frame_{name}"] = {
                "ms": cuda_ms(fn, 3),
                "single_ms": cuda_ms(lambda: compress_frame_device(x, 4, 1),
                                     3)}
        # K1's records mode (the gathered variant's rows) and the mesh
        # decode's K2 launch against their plain versions
        k = encode_kernel.encode_superblocks_records(x, 4, 2)
        p = in_chunks(lambda a: encode_kernel.encode_superblocks_index_plain(
            a, 4, 2, record_bound(sb // 1024, 4))[:4], (x,))
        err["encode_blocks"] = encode_err(k, p)
        del k, p, x
        (args, nb), prep_s = timed_s(lambda: mesh_decode_args(frames[1], 4,
                                                             dev))
        words = decode_kernel.decode_rows(*args, 4, nb)
        err["decode_rows"] = decode_err(
            words, in_chunks(decode_kernel.decode_rows_plain, args, 4, nb))
        # the mesh decode's steps one by one: the parse and upload, K2,
        # the gather, the copy down into a pinned buffer, from there into a
        # fresh output on threads
        pinned = torch.empty(words.numel(), dtype=torch.uint8,
                             pin_memory=True)
        w1["decompress_1_steps"] = {
            "parse_upload_ms": prep_s * 1e3,
            "k2_ms": cuda_ms(lambda: decode_kernel.decode_rows(*args, 4, nb),
                             3),
            "gather_ms": cuda_ms(lambda: par.sharding.all_gather(
                words, mesh.get_group()), 3),
            "d2h_ms": cuda_ms(lambda: pinned.copy_(words.view(-1)), 3),
            "to_output_ms": timed_s(lambda: staging.put(
                np.empty(words.numel(), np.uint8), [0, 0, words.numel()],
                pinned.numpy()))[1] * 1e3}
        del args, words, pinned
        check(max(err.values()) == 0, f"K1 records or the mesh decode's K2 "
              f"differ from their plain versions: {err}")
    finally:
        dist.destroy_process_group()
    for key, t in w1.items():
        mb = len(raw) / 1e6
        if key == "decompress_1_steps":
            log(f"mesh world 1 decompress level 1, its steps apart (ms): {t}")
        elif "single_ms" in t:
            log(f"mesh world 1 (NCCL) {key}: {t['ms']:.4f} ms = "
                f"{mb / t['ms']:.2f} GB/s; compress_frame_device "
                f"{t['single_ms']:.4f} ms = {mb / t['single_ms']:.2f} GB/s "
                f"[{card}]")
        else:
            log(f"mesh world 1 (NCCL) {key}: {t['mesh'] * 1e3:.1f} ms = "
                f"{mb / t['mesh'] / 1e3:.4f} GB/s; single device "
                f"{t['single'] * 1e3:.1f} ms = "
                f"{mb / t['single'] / 1e3:.4f} GB/s [{card}]")
    k12 = ("encode_blocks", "decode_rows")
    log(f"  K1, K2 launches: { {k: [v[n] for n in k12] for k, v in res['launches'].items()} }; "
        f"K1 records and K2 == plain versions: {err}")

    # (b) two gloo ranks on this card
    raw2 = sorted_int32(GLOO_MB * MIB, seed=GLOO_SEED)
    want, single, f2 = {}, {}, {}
    for lvl in (1, 2):
        f2[lvl], single[f"compress level {lvl}"] = timed_s(
            lambda: stt.compress(raw2, 4, lvl, device=dev))
        want[f"compress_{lvl}"] = digest(np.frombuffer(f2[lvl], np.uint8))
    single["decompress level 1"] = timed_s(
        lambda: stt.decompress(f2[1], 4, device=dev))[1]
    res["gloo2"]["single_device_s"] = single
    x2 = torch.from_numpy(raw2.copy()).to(dev).view(-1, sb)
    frame, length = compress_frame_device(x2, 4, 1)
    want["device_frame"] = digest(frame[: int(length)].cpu().numpy())
    del x2, frame
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
         "--port", str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GLOO_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"gloo rank {r} failed:\n{o[-4000:]}")
        got = json.loads(o.strip().splitlines()[-1])
        res["gloo2"][r] = got
        for key, d in want.items():
            check(got["digests"][key] == d, f"gloo rank {r}: {key} differs "
                  "from the single-device result")
        check(got["device_frame_shards_len"] == got["device_frame_len"],
              f"gloo rank {r}: shard lengths")
        for name, e in got["err"].items():
            err[name] = max(err[name], e)
        for path, counts in got["launches"].items():
            tot = res["launches"].setdefault(f"gloo2 {path}", {})
            for kname, v in counts.items():
                tot[kname] = tot.get(kname, 0) + v
    gl = {k: [v[n] for n in k12] for k, v in res["launches"].items()
          if k.startswith("gloo2")}
    for path, (k1, k2) in gl.items():
        check(k1 if "decompress" not in path else k2 == 2,
              f"{path}: K1 or K2 did not run on both ranks (launches)")
    log(f"two gloo ranks on one card, {GLOO_MB} MiB: frames, the mesh "
        "decompress and both device frames == the single-device results; "
        f"rank times (s): {[res['gloo2'][r]['times'] for r in range(2)]}; "
        f"one device in this process: {single}; K1, K2 launches (both "
        f"ranks): {gl} [{card}]")
    check(max(err.values()) == 0, f"mesh kernels differ: {err}")
    return res, err


def gloo_rank(rank, port):
    """One of phase_sharding's two gloo ranks, on cuda:0: compress(mesh=)
    at levels 1 and 2, decompress(mesh=) of the level-1 frame, the ragged
    shards (gathered back to compare) and the gathered device frame; K1 and
    K2 held against their plain versions at this rank's shapes. Prints one
    JSON line: digests, launch counts a path, errors, times."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=GLOO_TIMEOUT_S))
    pg = dist.group.WORLD
    raw = sorted_int32(GLOO_MB * MIB, seed=GLOO_SEED)
    out = {"digests": {}, "launches": {}, "times": {}, "err": {}}

    def run(path, fn):
        reset_counts()
        got, s = timed_s(fn)
        out["launches"][path] = read_counts()
        out["times"][path] = s
        return got

    frames = {}
    for level in (1, 2):
        frames[level] = run(f"compress level {level}",
                            lambda: stt.compress(raw, 4, level, mesh=pg))
        out["digests"][f"compress_{level}"] = digest(
            np.frombuffer(frames[level], np.uint8))
    frame1 = frames[1]
    back = run("decompress level 1", lambda: stt.decompress(frame1, 4,
                                                           mesh=pg))
    check(np.array_equal(back, raw), f"gloo rank {rank}: mesh decompress")
    sb = fr.super_block_size(1024)
    x = torch.from_numpy(raw.copy()).to(dev).view(-1, sb)
    half = x.shape[0] // 2
    local = x[rank * half:(rank + 1) * half]
    shard, total = run("device frame ragged",
                       lambda: par.compress_device_sharded(local, 4, 1, pg))
    lens = par.sharding.gather_ints([shard.numel()], pg, dev)[:, 0]
    whole = par.sharding.all_gather(
        torch.cat([shard, shard.new_zeros(int(lens.max()) - shard.numel())])
        [None], pg)
    joined = torch.cat([whole[r, :lens[r]] for r in range(2)])
    out["device_frame_shards_len"] = int(joined.numel())
    out["device_frame_len"] = total
    frame, length = run("device frame gathered",
                        lambda: par.compress_device_sharded_gathered(
                            local, 4, 1, pg))
    check(torch.equal(frame[:length].cpu(), joined.cpu()),
          f"gloo rank {rank}: gathered frame != ragged shards")
    out["digests"]["device_frame"] = digest(joined.cpu().numpy())
    # K1 (streams mode on this rank's superblocks) and K2 (this rank's
    # share of the level-1 frame) against their plain versions
    out["err"]["encode_blocks"] = encode_err(
        encode_kernel.encode_superblocks(local, 4, 2),
        encode_kernel.encode_superblocks_plain(local, 4, 2))
    args, nb = mesh_decode_args(frame1, 4, dev)
    mine = [a[rank * half:(rank + 1) * half] for a in args]
    out["err"]["decode_rows"] = decode_err(
        decode_kernel.decode_rows(*mine, 4, nb),
        decode_kernel.decode_rows_plain(*mine, 4, nb))
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def in_chunks(fn, row_args, *rest, per=CHUNK_BYTES // (128 * 1024)):
    """fn over slices of `per` rows of each of row_args, the outputs joined
    by row: a plain version over a whole path's input, without the
    intermediates of one call at that size."""
    n = row_args[0].shape[0]
    parts = [fn(*(a[i:i + per] for a in row_args), *rest)
             for i in range(0, n, per)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def phase_device(dev, raw, frame1):
    """The device-resident paths on the headline data, each with the launch
    counts set to 0 just before it and read just after: roundtrip_device,
    DeviceCompressedArray and compress_frame_device. K1b and K2b are held
    against their plain versions on the inputs of the calls these paths
    make: all 4096 slabs in one call ('jb' on K1b's records, 'bj' on the
    rows deserialize adopts from the level-1 headline frame); K1b and the
    plain versions are timed there (phase_decode_times times K2b); the
    device frame against the plain version's records."""
    sb = fr.super_block_size(1024)
    n_sb = len(raw) // sb
    nb = sb // 1024
    x = torch.from_numpy(raw.copy()).to(dev).view(n_sb, sb)
    res = {"launches": {}}
    err = {}
    times = {}

    reset_counts()
    out, rows, totals = roundtrip_device(x, 4, 2)
    res["launches"]["roundtrip"] = read_counts()
    check(torch.equal(out, x), "roundtrip_device output differs")
    del out
    ms = cuda_ms(lambda: roundtrip_device(x, 4, 2), 5)
    res["roundtrip"] = {"ms": ms, "gbps": len(raw) / ms / 1e6,
                        "ratio": len(raw) / int(totals.sum())}
    log(f"roundtrip_device {HEADLINE_MB} MiB: out == input, steady "
        f"{ms:.4f} ms = {res['roundtrip']['gbps']:.4f} GB/s; launches "
        f"{res['launches']['roundtrip']}")

    # K1b, then K2b 'jb', on the round trip's input and records
    width = record_bound(nb, 4)
    k = encode_kernel.encode_superblocks_index(x, 4, 2, width)
    check(torch.equal(k[0], rows) and torch.equal(k[1], totals),
          "K1b differs from the round trip's records")
    del rows
    plain = in_chunks(encode_kernel.encode_superblocks_index_plain, (x,), 4,
                      2, width)
    err["encode_blocks_index"] = encode_err(k, plain)
    check(err["encode_blocks_index"] == 0, "K1b at the round trip's shape")
    rec_bytes = int(totals.sum())
    # the input, the records, the index, the sizes
    moved = (x.numel() + rec_bytes + k[4].numel() * 4
             + 4 * (k[2].numel() + k[3].numel() + n_sb))
    times["encode_blocks_index"] = {
        "ms": cuda_ms(lambda: encode_kernel.encode_superblocks_index(
            x, 4, 2, width), 3),
        "plain_ms": cuda_ms(lambda: in_chunks(
            encode_kernel.encode_superblocks_index_plain, (x,), 4, 2, width),
            1),
        **encode_bound(x.numel(), moved, k[0].numel() - rec_bytes)}
    dec = decode_kernel.decode_rows_derive(k[0], k[4], 4, nb, "jb")
    err["decode_rows_derive"] = decode_err(dec, in_chunks(
        decode_kernel.decode_rows_derive_plain, (k[0], k[4]), 4, nb, "jb"))
    check(err["decode_rows_derive"] == 0, "K2b 'jb' at the round trip's "
          "shape")
    del dec
    times["decode_rows_derive"] = {
        "plain_ms": cuda_ms(lambda: in_chunks(
            decode_kernel.decode_rows_derive_plain, (k[0], k[4]), 4, nb,
            "jb"), 1)}
    del k

    a = raw.view("<u4")
    reset_counts()
    t0 = time.perf_counter()
    arr = stt.DeviceCompressedArray.from_array(a, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res["launches"]["container_build"] = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    back = arr.to_array()
    to_array_s = time.perf_counter() - t0
    check(np.array_equal(back, a), "container to_array")
    del back
    rng = np.random.default_rng(5)
    for i in rng.integers(0, arr.n_slabs, 100):
        got = arr.slab(int(i)).cpu().numpy()
        check(got.tobytes() == raw[i * arr.slab_bytes:
                                   (i + 1) * arr.slab_bytes].tobytes(),
              f"container slab {i}")
    for i in rng.integers(0, len(a), 1000):
        check(arr[int(i)] == a[i], f"container element {i}")
    res["launches"]["container_reads"] = read_counts()
    blob = arr.serialize()
    check(np.array_equal(stt.decompress(blob, 4, device=dev), raw),
          "container serialize")
    reset_counts()
    adopted = stt.DeviceCompressedArray.deserialize(frame1, "<u4", device=dev)
    check(np.array_equal(adopted.to_array(), a), "container deserialize")
    res["launches"]["container_deserialize"] = read_counts()
    res["container"] = {"build_s": build_s, "to_array_s": to_array_s,
                        "ratio": arr.current_compression_ratio(),
                        "footprint": arr.memory_footprint(),
                        "adopted_footprint": adopted.memory_footprint(),
                        "serialized_bytes": len(blob)}
    log(f"DeviceCompressedArray {HEADLINE_MB} MiB: build {build_s:.4f} s, "
        f"ratio {arr.current_compression_ratio():.4f}, footprint "
        f"{arr.memory_footprint()} B; to_array {to_array_s:.4f} s, 100 slab "
        "and 1000 element reads, serialize -> decompress and deserialize of "
        f"the level-1 headline frame == input; launches {res['launches']}")
    # K2b 'bj' on the rows and index deserialize adopted, as to_array ran it
    vb, pob = adopted._rows, adopted._plane_off
    err["decode_rows_derive"] = max(err["decode_rows_derive"], decode_err(
        decode_kernel.decode_rows_derive(vb, pob, 4, nb, "bj"),
        in_chunks(decode_kernel.decode_rows_derive_plain, (vb, pob), 4, nb,
                  "bj")))
    check(err["decode_rows_derive"] == 0, "K2b 'bj' at deserialize's shape")
    del arr, adopted, vb, pob

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame, length = compress_frame_device(x, 4, 1)
    torch.cuda.synchronize()
    fc_s = time.perf_counter() - t0
    res["launches"]["frame_compress"] = c = read_counts()
    check((c["encode_blocks"], c["frame_placed"])
          == (1, 1), f"compress_frame_device: not one frame-mode K1 "
          f"launch that zeroes the frame and places the records: {c}")
    got = frame[: int(length)].cpu().numpy().tobytes()
    check(np.array_equal(stt.decompress(got, 4, device=dev), raw),
          "compress_frame_device round trip")
    check(got == frame1, "compress_frame_device differs from the level-1 "
          "host-path frame")
    # the frame layout of K1 against the plain version's records
    keep = torch.arange(plain[0].shape[1], device=dev) < plain[1][:, None]
    want = torch.cat([frame[:fr.get_info(frame1, 4)[2]], plain[0][keep]])
    check(want.numel() == int(length) and not frame[int(length):].any(),
          "device frame length or padding")
    err["encode_blocks"] = int((frame[: int(length)].int()
                                - want.int()).abs().max())
    check(err["encode_blocks"] == 0, "device frame differs from the plain "
          "version's records")
    del frame, plain, keep, want
    # the same call on a block the allocator hands back dirtied, apart from
    # the timed first call: the same frame, zeros past it
    hdr = frame_header_bytes(len(raw), sb, 4, 1)
    cap = len(hdr) + n_sb * record_bound(nb, 4)
    frame, length = frame_on_dirty(lambda: compress_frame_device(x, 4, 1),
                                   cap, dev, ("compress_frame_device",
                                              HEADLINE_MB))
    check(int(length) == len(got)
          and frame[: len(got)].cpu().numpy().tobytes() == got,
          "compress_frame_device on a dirtied block differs")
    del frame
    warm_ms = cuda_ms(lambda: compress_frame_device(x, 4, 1), 3)
    # its one launch (K1 zeroes the frame and places the records), and the
    # same frame by two: K1's records mode, then the public place_records
    # (it zeroes the tail itself)
    rb = record_bound(nb, 4)
    rows_t, tot_t = encode_kernel._encode_rows(x, 4, 2, rb, 4, False)[:2]
    launch_ms = cuda_ms(lambda: encode_kernel._frame(x, 4, 2, hdr, rb), 10)
    apart_ms = [
        cuda_ms(lambda: encode_kernel._encode_rows(x, 4, 2, rb, 4, False),
                10),
        cuda_ms(lambda: encode_kernel.place_records(rows_t, tot_t, hdr, nb,
                                                    4), 10)]
    placed, placed_len = frame_on_dirty(lambda: encode_kernel.place_records(
        rows_t, tot_t, hdr, nb, 4), cap, dev, ("place_records", HEADLINE_MB))
    check(int(placed_len) == len(got)
          and placed[: len(got)].cpu().numpy().tobytes() == got,
          "place_records alone differs from compress_frame_device")
    del rows_t, tot_t, placed
    res["frame_compress"] = {"s": fc_s, "gbps": len(raw) / fc_s / 1e9,
                             "warm_ms": warm_ms,
                             "warm_gbps": len(raw) / warm_ms / 1e6,
                             "launch_ms": launch_ms,
                             "apart_ms": apart_ms, "bytes": len(got)}
    log(f"compress_frame_device {HEADLINE_MB} MiB level 1: first call "
        f"{fc_s:.4f} s = {res['frame_compress']['gbps']:.4f} GB/s, warm "
        f"{warm_ms:.4f} ms = {res['frame_compress']['warm_gbps']:.4f} GB/s "
        f"(its K1 launch {launch_ms:.4f} ms; K1 records mode "
        f"{apart_ms[0]:.4f} + place_records zeroing the tail "
        f"{apart_ms[1]:.4f} ms); frame == "
        "the host-path frame and the plain version's records, zeros past "
        "it, decodes to the input; again on a dirtied block and from "
        "place_records alone: the same frame, zeros past it; launches "
        f"{res['launches']['frame_compress']}")
    for name, t in times.items():
        log(f"{name} at {HEADLINE_MB} MiB (one call, {n_sb} slabs): "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                        else f"{k} {v}" for k, v in t.items()))
    log(f"device-path kernels == plain versions at their paths' shapes: {err}")
    return res, times, err


COLUMN_SAMPLES = 86_400_000 - 4321  # a day of 1 kHz float64 samples, cut


def ts_column(dev, nbytes, seed=3):
    """nbytes of float64 samples made on the card: 100 + a random walk of
    N(0, 1e-3) steps + a daily and an hourly wave on a 1 kHz clock
    (benchs/datasets.py's ts_f64)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    m = -(-nbytes // 8)
    t = torch.arange(m, device=dev, dtype=torch.float64)
    v = torch.randn(m, generator=g, device=dev, dtype=torch.float64)
    v = v.mul_(1e-3).cumsum_(0).add_(100.0)
    v += (t * (2 * np.pi / 86.4e6)).sin_().mul_(0.5)
    v += (t * (2 * np.pi / 3.6e6)).sin_().mul_(0.05)
    return v.view(torch.uint8)[:nbytes]


def phase_column(dev):
    """compress_frame_device on 1-D float64 columns (bytesoftype 8, level
    1) of every kind of end: none, whole blocks, a partial segment, a length
    no multiple of 8, the small-input route (ZSTD and COPY), a column
    shorter than a superblock: each frame the host path's and the CPU plain
    version's, zeros past it, its launches (one frame-mode K1, and
    encode_short for a partial segment) and engine.short_superblocks*. Then
    a day's column: its frame on a dirtied block, its records those of the
    2-D frame of its whole superblocks and of its short superblock alone,
    K1 by events beside that 2-D frame's, encode_short and the call."""
    sb, blk = 131072, 2048
    base = ts_column(dev, 8 * 300_000)
    held = base[: sb + 120].clone()
    held[-112:] = held[-120:-112].repeat(14)  # a held sample: ZSTD shrinks it
    cases = {"whole": base[: 2 * sb], "whole_blocks": base[: sb + 3 * blk],
             "partial": base[: sb + 3 * blk + 704],
             "not_multiple_of_8": base[: 3 * sb + blk + 701],
             "partial_no_line": base[: sb + blk + 56],
             "small_copy": base[: sb + 100], "small_zstd": held,
             "shorter_than_a_superblock": base[:5000],
             "small_column": base[:100], "longest_short": base[: 2 * sb - 1]}
    res = {"launches": {}}
    for name, col in cases.items():
        col = col.contiguous()
        n = col.numel()
        n_full, r = divmod(n, sb)
        reset_counts()
        short0 = (eng.short_superblocks, eng.short_superblocks_small)
        frame, length = compress_frame_device(col, 8, 1)
        counts = read_counts()
        res["launches"][name] = counts
        short = (eng.short_superblocks - short0[0],
                 eng.short_superblocks_small - short0[1])
        got = frame[: int(length)].cpu().numpy().tobytes()
        check(got == fr.compress(col.cpu().numpy(), 8, 1, engine=None),
              f"column {name}: differs from the host path's frame")
        plain, plain_len = compress_frame_device(col.cpu(), 8, 1)
        check(int(plain_len) == int(length)
              and torch.equal(frame.cpu(), plain),
              f"column {name}: differs from the CPU plain version")
        check(not frame[int(length):].any(), f"column {name}: padding")
        block = int(n_full > 0 or r >= eng.SMALL_INPUT)
        check(counts["encode_blocks"] == counts["frame_placed"] == block
              and counts["encode_short"] == int(
                  r >= eng.SMALL_INPUT and r % blk > 0),
              f"column {name}: launches {counts}")
        check(short == (int(r > 0), int(0 < r < eng.SMALL_INPUT)),
              f"column {name}: short-superblock counters {short}")
    log(f"columns: {len(cases)} kinds of end, each the host path's frame "
        "and the plain version's, zeros past it, its launches and counters")

    # a day's column
    col = ts_column(dev, 8 * COLUMN_SAMPLES)
    n = col.numel()
    n_full, r = divmod(n, sb)
    frame, length = compress_frame_device(col, 8, 1)
    cap = frame.numel()
    del frame
    frame, length = frame_on_dirty(lambda: compress_frame_device(col, 8, 1),
                                   cap, dev, ("compress_frame_device",
                                              "column"))
    whole = col[: n_full * sb].view(n_full, sb)
    f2, l2 = compress_frame_device(whole, 8, 1)
    h2 = len(frame_header_bytes(n_full * sb, sb, 8, 1))
    hc = len(frame_header_bytes(n, sb, 8, 1))
    body = int(l2) - h2
    check(torch.equal(frame[hc : hc + body], f2[h2 : int(l2)]),
          "column: whole superblocks differ from the 2-D frame's")
    fs, ls = compress_frame_device(col[n_full * sb :].cpu(), 8, 1)
    hs = len(frame_header_bytes(r, sb, 8, 1))
    check(int(length) == hc + body + int(ls) - hs
          and torch.equal(frame[hc + body : int(length)].cpu(),
                          fs[hs : int(ls)]),
          "column: the short superblock differs from the plain version's")
    del f2, fs
    eng.timing = []
    for _ in range(20):
        compress_frame_device(col, 8, 1)
        compress_frame_device(whole, 8, 1)
    torch.cuda.synchronize()
    recs = trace.records()
    eng.timing = None
    kind = {s.id: "column" if s.nbytes == n else "whole" for s in recs
            if s.name == "stn.compress_frame_device"}
    k1 = {"column": [], "whole": []}
    for s in recs:
        if s.name == "stn.k1.launch":
            k1[kind[s.call]].append(s.device_ms())
    short = [s.device_ms() for s in recs if s.name == "stn.short_superblock"]
    res["times"] = {
        "k1_column_ms": float(np.median(k1["column"])),
        "k1_whole_ms": float(np.median(k1["whole"])),
        "encode_short_ms": float(np.median(short)),
        "call_ms": cuda_ms(lambda: compress_frame_device(col, 8, 1), 20),
        "bytes": n, "frame_bytes": int(length)}
    log(f"column of {n} bytes ({r} past {n_full} superblocks): frame "
        f"{int(length)} bytes, the 2-D frame's records and the plain "
        f"short record; K1 {res['times']['k1_column_ms']:.4f} ms (whole "
        f"superblocks alone {res['times']['k1_whole_ms']:.4f}), "
        f"encode_short {res['times']['encode_short_ms']:.4f}, the call "
        f"{res['times']['call_ms']:.4f} ms")
    del frame, col, whole
    torch.cuda.empty_cache()
    return res


def fold_data(dev, bpp, n_sb, sb):
    """n_sb superblocks of sb bytes made on the card: a ts-f64 walk's bytes,
    every third superblock and the first eight random bytes (records at
    their bound, filling their slots exactly) and every third from the
    third a constant (records of a few bytes)."""
    x = ts_column(dev, n_sb * sb, seed=bpp).view(n_sb, sb).clone()
    g = torch.Generator(device=dev)
    g.manual_seed(n_sb)
    for rows in (x[0::3], x[:8]):
        rows.copy_(torch.randint(0, 256, rows.shape, generator=g, device=dev,
                                 dtype=torch.uint8))
    x[2::3] = 7
    return x


def plain_frame(x, bpp, hdr, cap):
    """The frame of (n_sb, sb) x by the plain version on the card (its
    records in slices, header first, zeros to cap)."""
    nb = x.shape[1] // (256 * bpp)
    rows, totals = in_chunks(
        lambda a: encode_kernel.encode_superblocks_index_plain(
            a, bpp, 2, record_bound(nb, bpp))[:2], (x,))
    body = rows[torch.arange(rows.shape[1], device=x.device)
                < totals[:, None]]
    frame = torch.zeros(cap, dtype=torch.uint8, device=x.device)
    frame[: len(hdr)] = torch.tensor(list(hdr), dtype=torch.uint8)
    frame[len(hdr) : len(hdr) + body.numel()] = body
    return frame, len(hdr) + body.numel()


def column_ends(bpp, sb):
    """Eleven column lengths for a bpp: no short superblock, whole blocks,
    a partial segment with lines and without, lengths no multiple of the
    element, the small-input route (under 128 bytes past the superblocks,
    at 127 and at 128), a column shorter than a superblock and than one
    block, the longest short superblock."""
    blk = 256 * bpp
    return [2 * sb, sb + 3 * blk, sb + 3 * blk + 32 * bpp + 7,
            sb + blk + min(56, 16 * bpp - 1), 3 * sb + blk + 701,
            sb + 100, sb + 127, sb + 128, 5000, 100, 2 * sb - 1]


def phase_fold(dev):
    """The frame mode's one launch (K1 zeroes the frame, encodes, finds each
    record's place by a decoupled look-back and copies the record there)
    against two references, byte for byte over the whole capacity: the
    plain version on the card and K1's records placed by the public
    place_records. The grid: FOLD_BPP x FOLD_N_SB superblocks (fold_data),
    each frame on a dirtied block with dirtied small blocks (the look-back
    state), one K1 launch and no place_records a frame; 55 column lengths
    (column_ends at bpp 1, 2, 4, 8, 16) against the CPU plain version, on
    dirtied blocks (phase_column holds bpp 8 to the host path); then 200
    calls back to back on one stream over 4 inputs (2-D at bpp 4, columns
    at bpp 8), each frame its input's first."""
    res = {"grid": 0, "columns": 0}
    for bpp in FOLD_BPP:
        sb = fr.super_block_size(256 * bpp)
        nb = sb // (256 * bpp)
        for n_sb in FOLD_N_SB:
            x = fold_data(dev, bpp, n_sb, sb)
            hdr = frame_header_bytes(n_sb * sb, sb, bpp, 1)
            cap = len(hdr) + n_sb * record_bound(nb, bpp)
            what = ("fold", bpp, n_sb)
            reset_counts()
            frame, length = frame_on_dirty(
                lambda: compress_frame_device(x, bpp, 1), cap, dev, what)
            c = read_counts()
            check((c["encode_blocks"], c["frame_placed"]) == (1, 1),
                  (*what, "launches", c))
            want, n = plain_frame(x, bpp, hdr, cap)
            check(int(length) == n and torch.equal(frame, want),
                  (*what, "differs from the plain version"))
            del want
            rows, totals = encode_kernel.encode_superblocks_records(
                x, bpp, 2)[:2]
            placed, placed_len = encode_kernel.place_records(
                rows, totals - 4, hdr, nb, bpp)
            check(int(placed_len) == n and torch.equal(frame, placed),
                  (*what, "differs from the records placed by "
                   "place_records"))
            del x, frame, rows, placed
            res["grid"] += 1
    log(f"folded frames == the plain version and K1 records + place_records "
        f"over the capacity: bpp {FOLD_BPP} x {FOLD_N_SB} superblocks, each "
        "on dirtied blocks, one K1 launch a frame")

    base = ts_column(dev, 8 * (300_000 + 4 * 16384))
    for bpp in (1, 2, 4, 8, 16):
        sb = fr.super_block_size(256 * bpp)
        for n in column_ends(bpp, sb):
            col = base[:n].clone()
            n_full, r = divmod(n, sb)
            block = int(n_full > 0 or r >= eng.SMALL_INPUT)
            cap = compress_frame_device(col, bpp, 1)[0].numel()
            reset_counts()
            frame, length = frame_on_dirty(
                lambda: compress_frame_device(col, bpp, 1), cap, dev,
                ("column", bpp, n))
            c = read_counts()
            check(c["encode_blocks"] == c["frame_placed"] == block
                  and c["encode_short"] == int(r >= eng.SMALL_INPUT
                                               and r % (256 * bpp) > 0),
                  ("column", bpp, n, "launches", c))
            plain, plain_len = compress_frame_device(col.cpu(), bpp, 1)
            check(int(plain_len) == int(length)
                  and torch.equal(frame.cpu(), plain),
                  ("column", bpp, n, "differs from the CPU plain version"))
            res["columns"] += 1
    del base
    log(f"{res['columns']} column lengths at bpp 1, 2, 4, 8, 16 == the CPU "
        "plain version, on dirtied blocks; one K1 launch, and encode_short "
        "for a partial segment")

    sb = 131072
    inputs = [fold_data(dev, 4, 600, sb), sorted_int32_device(dev, 600 * sb)]
    for k, extra in enumerate((704, 5)):
        inputs.append(ts_column(dev, 12 * sb + 3 * 2048 + extra, seed=20 + k))
    refs = []
    for k, x in enumerate(inputs):
        frame, length = compress_frame_device(x, 4 if x.dim() == 2 else 8, 1)
        if x.dim() == 2:
            want, n = plain_frame(x, 4, frame_header_bytes(
                x.numel(), sb, 4, 1), frame.numel())
            check(int(length) == n and torch.equal(frame, want),
                  ("back to back", k, "differs from the plain version"))
        else:
            plain, plain_len = compress_frame_device(x.cpu(), 8, 1)
            check(int(plain_len) == int(length)
                  and torch.equal(frame.cpu(), plain),
                  ("back to back", k, "differs from the CPU plain version"))
        refs.append((frame, int(length)))
    torch.cuda.synchronize()
    outs = [compress_frame_device(inputs[i % 4], 4 if i % 4 < 2 else 8, 1)
            for i in range(200)]
    torch.cuda.synchronize()
    for i, (frame, length) in enumerate(outs):
        want, n = refs[i % 4]
        check(int(length) == n and torch.equal(frame, want),
              ("back to back", i, "differs from its input's first frame"))
    res["back_to_back"] = len(outs)
    del outs, refs, inputs
    torch.cuda.empty_cache()
    log("200 calls back to back on one stream over 4 inputs (2-D at bpp 4, "
        "columns at bpp 8): each frame its input's first")
    return res


def sorted_int32_device(dev, nbytes, seed=5):
    """nbytes of sorted uint32 below 2^30 made on the card, (n, 131072)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    v = torch.randint(0, 1 << 30, (nbytes // 4,), generator=g, device=dev,
                      dtype=torch.int64).sort().values.to(torch.int32)
    return v.view(torch.uint8).view(-1, 131072)


LAUNCH_CALLS = 200  # phase_launch's calls back to back
SPLIT_CALLS = 100  # calls a turn of phase_launch_times' host split


def allocations(fn, dev):
    """(fn(), the device allocations it made)."""
    torch.cuda.synchronize()
    a = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    out = fn()
    return out, torch.cuda.memory_stats(dev)["allocation.all.allocated"] - a


def phase_launch(dev):
    """K1's launch descriptors (ops/encode_kernel.py _descriptor) from an
    empty cache, over LAUNCH_CALLS compress_frame_device calls back to back
    that change key at every call: 2-D at bpp 4 (nb 128, the sorted
    cell's), a column at bpp 8 (nb 64, the column cell's: K1's column
    instantiation and encode_short), 2-D at bpp 8 (nb 64) and 2-D at bpp 4
    with 64 KiB superblocks (nb 64). descriptor_builds equals the number
    of distinct keys, 4, and no call after each key's first builds; each
    input's first frame equals the plain version and every later frame its
    input's first. One call runs under a side stream: its K1 span's events
    lie on that stream, and the side stream's own events around the call
    hold K1's time. A frame-mode call makes 3 device allocations."""
    sb = 131072
    inputs = [(fold_data(dev, 4, 600, sb), 4),
              (ts_column(dev, 12 * sb + 3 * 2048 + 704, seed=30), 8),
              (fold_data(dev, 8, 300, sb), 8),
              (sorted_int32_device(dev, 600 * sb).reshape(-1, sb // 2), 4)]
    encode_kernel._descriptors.clear()
    encode_kernel.descriptor_builds = 0
    refs = []
    for k, (x, bpp) in enumerate(inputs):
        (frame, length), n_alloc = allocations(
            lambda: compress_frame_device(x, bpp, 1), dev)
        check(n_alloc == 3, ("launch", k, "device allocations", n_alloc))
        if x.dim() == 2:
            want, n = plain_frame(x, bpp, frame_header_bytes(
                x.numel(), x.shape[1], bpp, 1), frame.numel())
            check(int(length) == n and torch.equal(frame, want),
                  ("launch", k, "differs from the plain version"))
            del want
        else:
            plain, plain_len = compress_frame_device(x.cpu(), bpp, 1)
            check(int(plain_len) == int(length)
                  and torch.equal(frame.cpu(), plain),
                  ("launch", k, "differs from the CPU plain version"))
        refs.append((frame, int(length)))
    keys = sorted(encode_kernel._descriptors)
    check(len(keys) == 4 and encode_kernel.descriptor_builds == 4,
          ("launch descriptors", keys, encode_kernel.descriptor_builds))
    # the reference for the side stream's events: K1's time on input 0
    k1_ms = cuda_ms(lambda: compress_frame_device(inputs[0][0], 4, 1), 5)
    side_at = LAUNCH_CALLS // 2  # a call on input 0
    side = torch.cuda.Stream(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for i in range(LAUNCH_CALLS):
        x, bpp = inputs[i % 4]
        if i != side_at:
            outs.append(compress_frame_device(x, bpp, 1))
            continue
        side.wait_stream(torch.cuda.current_stream(dev))
        eng.timing = []  # the recorder on, for this call's spans
        with torch.cuda.stream(side):
            ev[0].record()
            outs.append(compress_frame_device(x, bpp, 1))
            ev[1].record()
        eng.timing = None
        torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    spans = [r for r in trace.records() if r.name == "stn.k1.launch"]
    side_ms = ev[0].elapsed_time(ev[1])
    check(len(spans) == 1
          and spans[0]._queue.cuda_stream == side.cuda_stream
          and side_ms >= 0.5 * k1_ms,
          ("side stream: K1 not on it", len(spans), side_ms, k1_ms))
    for i, (frame, length) in enumerate(outs):
        want, n = refs[i % 4]
        check(int(length) == n and torch.equal(frame, want),
              ("launch", i, "differs from its input's first frame"))
    check(encode_kernel.descriptor_builds == 4,
          ("launch descriptors built in the loop",
           encode_kernel.descriptor_builds))
    res = {"calls": LAUNCH_CALLS, "keys": [list(k) for k in keys],
           "descriptor_builds": encode_kernel.descriptor_builds,
           "lags": {str(k): encode_kernel._descriptors[k][0].lag
                    for k in keys},
           "side_stream_ms": side_ms, "k1_ms": k1_ms}
    del outs, refs, inputs
    torch.cuda.empty_cache()
    log(f"launch descriptors: {res}; {LAUNCH_CALLS} calls back to back "
        "over 4 keys == each input's first frame == the plain version, 3 "
        "device allocations a call, K1 on the side stream under it")
    return res


class Stamped:
    """A kernel library whose named C entries append (name,
    time.perf_counter_ns()) to stamps as they are entered and as they
    return; every other attribute is the library's."""

    def __init__(self, lib, names, stamps):
        self._lib = lib
        for name in names:
            fn = getattr(lib, name)

            def call(*args, fn=fn, name=name):
                stamps.append((name, time.perf_counter_ns()))
                r = fn(*args)
                stamps.append((name, time.perf_counter_ns()))
                return r

            setattr(self, name, call)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def launch_split(fn, calls, stamps):
    """calls of fn() (a compress_frame_device) as the cells make them: the
    length copied to pinned host memory and waited for before the next
    call, CUDA events before the call and behind the copy. Medians of the
    host's ns stamps (stamps: K1's and encode_short's C entries, Stamped)
    in ms: entry to K1's C entry (to_k1), inside it (k1_call), encode_short's
    C entry (short_call), K1's return to the call's (after), the whole call
    (host), and the events' time (call, p50 and p95)."""
    pinned = torch.empty((), dtype=torch.int64, pin_memory=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    rows = []
    for _ in range(calls):
        stamps.clear()
        ev[0].record()
        t0 = time.perf_counter_ns()
        frame, length = fn()
        t1 = time.perf_counter_ns()
        pinned.copy_(length, non_blocking=True)
        ev[1].record()
        ev[1].synchronize()
        k1 = [t for n, t in stamps if n == "stenos_encode_superblocks"]
        short = [t for n, t in stamps if n == "stenos_encode_short"]
        rows.append({"to_k1": k1[0] - t0, "k1_call": k1[1] - k1[0],
                     "short_call": short[1] - short[0] if short else 0,
                     "after": t1 - k1[1], "host": t1 - t0,
                     "call": ev[0].elapsed_time(ev[1]) * 1e6})
        del frame, length
    out = {}
    for key in rows[0]:
        v = sorted(r[key] for r in rows)
        out[key] = v[len(v) // 2] / 1e6
    v = sorted(r["call"] for r in rows)
    out["call_p95"] = v[int(0.95 * (len(v) - 1))] / 1e6
    return out


def phase_launch_times(dev, old):
    """This tree's launch path against the old one's (old: the parent
    commit's package, load_old), in turns (old, new, new, old), outputs
    equal: at the two cells' calls (4096 superblocks of sorted int32 at bpp
    4; a day's float64 column at bpp 8), the host split of the launch path
    (launch_split, SPLIT_CALLS calls a turn: both trees' K1 and
    encode_short C entries stamped), a call's device allocations, and the
    calls back to back by CUDA events; the public place_records; K1's
    streams-mode launch at 64 MiB and K1b at 512 MiB. ptxas's report of
    both sources."""
    res = {}
    x = sorted_int32_device(dev, 512 * MIB)
    col = ts_column(dev, 8 * COLUMN_SAMPLES)
    stamps = []
    loads = {}
    for mod in (encode_kernel, old.encode_kernel):
        load = loads[mod] = mod._cuda.load
        libs = {}

        def stamped(name, sig, load=load, libs=libs):
            if name not in libs:
                libs[name] = load(name, sig)
                if name == "encode_blocks":
                    libs[name] = Stamped(libs[name], (
                        "stenos_encode_superblocks", "stenos_encode_short"),
                        stamps)
            return libs[name]

        mod._cuda.load = stamped
    try:
        for name, args in (("sorted", (x, 4, 1)), ("column", (col, 8, 1))):
            sides = {"new": lambda: compress_frame_device(*args),
                     "old": lambda: old.engine.compress_frame_device(*args)}
            a, b = (f()[0] for f in (sides["new"], sides["old"]))
            check(torch.equal(a, b), f"frame {name}: differs from the old "
                  "tree's")
            del a, b
            r = {"split": {"new": [], "old": []}}
            for who in ("old", "new", "new", "old"):
                r["split"][who].append(launch_split(sides[who], SPLIT_CALLS,
                                                    stamps))
            for who in ("new", "old"):
                r["allocations_" + who] = allocations(sides[who], dev)[1]
                r[who] = {k: sum(t[k] for t in r["split"][who]) / 2
                          for k in r["split"][who][0]}
            r["back_to_back"] = in_turns(f"frame {name}", sides["new"],
                                         sides["old"], 10)
            res[name] = r
    finally:
        for mod, load in loads.items():
            mod._cuda.load = load
    sb = 131072
    nb = sb // 1024
    rb = record_bound(nb, 4)
    hdr = frame_header_bytes(x.numel(), sb, 4, 1)
    # the public place_records (the gathered mesh frame's), on K1's records
    rows_r, tot_r = encode_kernel.encode_superblocks_records(x, 4, 2)[:2]
    res["place_records"] = in_turns(
        "place_records", lambda: encode_kernel.place_records(
            rows_r, tot_r - 4, hdr, nb, 4),
        lambda: old.encode_kernel.place_records(rows_r, tot_r - 4, hdr, nb,
                                                4), 10)
    del rows_r, tot_r
    x64 = x[:512]
    for _ in range(2):  # two rounds of turns each
        for key, name, new, old_fn, reps in (
                ("k1_streams_64mib", "K1 streams launch",
                 lambda: encode_kernel._encode_rows(
                     x64, 4, 2, rb - 4, 0, False)[1:4],
                 lambda: old.encode_kernel._encode_rows(
                     x64, 4, 2, rb - 4, 0, False, False)[1:4], 50),
                ("k1b_512mib", "K1b",
                 lambda: encode_kernel.encode_superblocks_index(x, 4, 2, rb),
                 lambda: old.encode_kernel.encode_superblocks_index(
                     x, 4, 2, rb), 20)):
            res.setdefault(key, []).append(in_turns(name, new, old_fn, reps))
    for name, path in (("new", _cuda.BUILD_DIR),
                       ("old", os.path.join(os.path.dirname(
                           old.encode_kernel.__file__), "..", "build"))):
        with open(os.path.join(path, "encode_blocks.ptxas.txt")) as f:
            res[f"ptxas_{name}"] = [ln.strip() for ln in f
                                    if "registers" in ln or "spill" in ln
                                    or "Compiling entry" in ln]
    for k, v in res.items():
        log(f"launch times {k}: {v}")
    del x, col
    torch.cuda.empty_cache()
    return res


def load_old(src):
    """The kernel modules of the package in another checkout (the parent
    commit's: the old design), loaded under the name old_stenos_tpu_torch
    with its own build directory: .decode_kernel (K2, K2b), .huff_kernel
    (K4), .huff_decode_kernel (K5), .fse_kernel (K6), .encode_kernel (K1,
    K1b, place_records) and .engine."""
    pkg = os.path.join(os.path.abspath(src), "stenos_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "old_stenos_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return SimpleNamespace(**{
        name.rsplit(".", 1)[-1]: importlib.import_module(
            f"old_stenos_tpu_torch.{name}")
        for name in ("ops.decode_kernel", "entropy.huff_kernel",
                     "entropy.huff_decode_kernel", "entropy.fse_kernel",
                     "ops.encode_kernel", "engine")})


def in_turns(name, new, old, reps, timers=(("ms", cuda_ms),)):
    """Mean times of new() and, given old, of old() on the same inputs, in
    turns (old, new, new, old), by each timer: {key: ms, "old_" + key: ms}.
    old()'s outputs must equal new()'s."""
    def outs(fn):
        got = fn()
        return got if isinstance(got, tuple) else (got,)

    if old is not None:
        check(all(torch.equal(a, b) for a, b in zip(outs(new), outs(old))),
              f"{name}: the new kernel differs from the old design")
    res = {}
    for key, timer in timers:
        ms = {"old": [], "new": []}
        for who in ("old", "new", "new", "old") if old else ("new",):
            ms[who].append(timer(old if who == "old" else new, reps))
        res[key] = sum(ms["new"]) / len(ms["new"])
        if old is not None:
            res["old_" + key] = sum(ms["old"]) / len(ms["old"])
    return res


def phase_decode_times(dev, raw, frame1, old=None):
    """K2 and K2b timed at the shapes their paths give them, each beside its
    bound: K2 on a 64 MiB batch of the level-1 headline frame and on one
    superblock; K2b on the 512 MiB round trip's records ('jb'), on the rows
    deserialize adopts from the level-1 frame ('bj'), and on one slab of
    each (bpp 4, nb 32) and of a low-cardinality bpp-1 container (nb 128).
    Each new call is held against the plain version, or at 512 MiB against
    the earlier phases' comparison of the same inputs. With old (load_old),
    the old design on the same inputs, in turns (in_turns). Times are
    queued_ms (ms: the card's), and cuda_ms beside them (called_ms: as a
    caller sees a call)."""
    sb = fr.super_block_size(1024)
    nb = sb // 1024
    n_sb = len(raw) // sb
    per_call = CHUNK_BYTES // sb
    streams = block_streams(frame1, 4)[1]
    cases = {}
    for name, batch in (("k2_64mib", streams[:per_call]),
                        ("k2_one_superblock", streams[:1])):
        vb, po, rt, vlens = parsed_index(batch, 4, sb)
        a = [torch.from_numpy(v).to(dev) for v in (vb, po, rt)]
        cases[name] = ("decode_rows", (*a, 4, nb),
                       int(vlens.sum()) + po.nbytes + rt.nbytes,
                       len(batch) * sb)
    x = torch.from_numpy(raw.copy()).to(dev).view(n_sb, sb)
    rows, totals, _, _, po = encode_kernel.encode_superblocks_index(
        x, 4, 2, record_bound(nb, 4))
    del x
    adopted = stt.DeviceCompressedArray.deserialize(frame1, "<u4", device=dev)
    lc = torch.from_numpy(low_card(np.random.default_rng(9), 32768)).to(
        dev).view(1, -1)
    rows1, tot1, _, _, po1 = encode_kernel.encode_superblocks_index(
        lc, 1, 2, record_bound(128, 1))
    for name, r, t, p, bpp, order in (
            ("k2b_jb_512mib", rows, totals, po, 4, "jb"),
            ("k2b_bj_512mib", adopted._rows, torch.from_numpy(
                adopted._totals), adopted._plane_off, 4, "bj"),
            ("k2b_one_slab_bpp4", rows[7:8], totals[7:8], po[7:8], 4, "jb"),
            ("k2b_one_slab_bpp1", rows1, tot1, po1, 1, "jb")):
        nbk = p.shape[1] // bpp
        cases[name] = ("decode_rows_derive", (r, p, bpp, nbk, order),
                       int(t.sum()) + p.numel() * 4,
                       r.shape[0] * nbk * 256 * bpp)
    res = {}
    for name, (fn, args, moved, out_bytes) in cases.items():
        new = getattr(decode_kernel, fn)
        got = new(*args)
        if got.numel() <= CHUNK_BYTES:
            check(torch.equal(got, getattr(decode_kernel, fn + "_plain")(
                *args)), f"{name}: the kernel differs from its plain version")
        del got
        res[name] = {
            **in_turns(name, lambda: new(*args),
                       old and (lambda: getattr(old.decode_kernel, fn)(*args)),
                       5 if out_bytes > CHUNK_BYTES else 20,
                       (("ms", queued_ms), ("called_ms", cuda_ms))),
            **decode_bound(moved + out_bytes, out_bytes),
            "out_bytes": out_bytes}
        log(f"{name}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in res[name].items()))
    del rows, totals, po, adopted, rows1
    return res


def timed(fn):
    """(fn(), its device time in ms by CUDA events): one run, for plain
    versions whose run is also the one compared."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def low_card_device(dev, nbytes, seed=42):
    """low_card's distribution drawn on the device (torch generator, seeded),
    returned as a host array: 512 MiB of numpy draws would take the host
    tens of seconds."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = 1.0 / np.arange(1, 31)
    cdf = torch.from_numpy(np.cumsum(p / p.sum())).to(dev, torch.float32)
    u = torch.rand(nbytes, generator=g, device=dev)
    k = torch.searchsorted(cdf, u, right=True).clamp_(max=29)
    return (k + 97).to(torch.uint8).cpu().numpy()


def entropy_kernels(dev, src, e, err, times=None, old=None):
    """K3, K4 and K5 against their plain versions on the full inputs of the
    calls an entropy build and its to_array make: K3 and K4 on the record
    blocks of src (the entropy=False container of the same array), every
    output compared; K5 on the store e's coded rows (none when e is None,
    the stage dropped). The store's rows must be the encode's rows of its
    coded blocks, and K5 must give those blocks back. Maxima go into err;
    with times given, each kernel is timed there too (torch.bincount as
    K3's library yardstick) with the bytes its bound counts, and with old
    (load_old) K4 and K5 of the old design beside the new, in turns."""
    blocks = record_blocks(src._rows, src._totals)
    nblk = blocks.shape[0]
    check(e is None or len(e.flags) == nblk, "record blocks")

    def keep(name, e_):
        err[name] = max(err.get(name, 0), e_)

    hist = huff_kernel.histogram(blocks)
    p, p_ms = timed(lambda: in_chunks(huff_kernel.histogram_plain, (blocks,)))
    keep("huff_histogram", huff_err((hist,), (p,)))
    if times is not None:
        keys = (torch.arange(nblk, device=dev)[:, None] * 256
                + blocks).view(-1)
        times["huff_histogram"] = {
            "ms": cuda_ms(lambda: huff_kernel.histogram(blocks), 10),
            "plain_ms": p_ms,
            "library_ms": cuda_ms(
                lambda: torch.bincount(keys, minlength=nblk * 256), 10),
            "bytes": blocks.numel() + hist.numel() * 4}
        del keys
    lens, luts = luts_batch(hist.cpu().numpy())
    lut = torch.from_numpy(np.repeat(luts, 4, axis=0)).to(dev)
    streams = blocks.view(-1, STREAM)
    enc = huff_kernel.encode_streams(streams, lut, with_anchors=True)
    p, p_ms = timed(lambda: in_chunks(huff_kernel.encode_streams_plain,
                                      (streams, lut), True))
    keep("huff_encode_streams", huff_err(enc, p))
    del p
    if times is not None:
        # one LUT per block: its four streams share it
        # bytes: the bitstreams as the bound counts them; rows_bytes: the
        # contract's whole rows (each bitstream and its zeros to 48 KiB)
        side = streams.numel() + luts.nbytes + enc[2].numel() * 4 \
            + enc[1].numel() * 4
        times["huff_encode_streams"] = {
            **in_turns("K4", lambda: huff_kernel.encode_streams(
                streams, lut, with_anchors=True),
                old and (lambda: old.huff_kernel.encode_streams(
                    streams, lut, with_anchors=True)), 10),
            "plain_ms": p_ms,
            "bytes": side + int(enc[1].sum()),
            "rows_bytes": side + enc[0].numel() * 4}
        times["huff_encode_streams"]["rows_bound_ms"] = (
            times["huff_encode_streams"]["rows_bytes"] / HBM_BYTES_PER_S * 1e3)
    if e is None:
        return
    coded = np.flatnonzero(e.flags)
    ridx = torch.from_numpy((coded[:, None] * 4 + np.arange(4)).reshape(-1)
                            ).to(dev)
    check(torch.equal(e.words, enc[0][ridx, : e.words.shape[1]])
          and torch.equal(e.anchors, enc[2][ridx])
          and np.array_equal(e.sizes, enc[1][ridx].cpu().numpy()),
          "the store's rows differ from the encode of the record blocks")
    del enc
    wb = e.words.view(torch.uint8)
    out = huff_decode_kernel.decode_streams(wb, e.anchors, e.tabs)
    p, p_ms = timed(lambda: in_chunks(huff_decode_kernel.decode_streams_plain,
                                      (wb, e.anchors, e.tabs)))
    keep("huff_decode_streams", huff_err((out,), (p,)))
    check(torch.equal(out.view(-1, BLOCK),
                      blocks[torch.from_numpy(coded).to(dev)]),
          "K5 of the store differs from the record blocks")
    del p, out
    if times is not None:
        # one table per coded block: its four streams share it
        times["huff_decode_streams"] = {
            **in_turns("K5", lambda: huff_decode_kernel.decode_streams(
                wb, e.anchors, e.tabs),
                old and (lambda: old.huff_decode_kernel.decode_streams(
                    wb, e.anchors, e.tabs)), 10),
            "plain_ms": p_ms,
            "bytes": (int(e.sizes.sum()) + e.anchors.numel() * 4
                      + len(coded) * e.tabs.shape[1] * 4
                      + wb.shape[0] * STREAM)}


def phase_entropy(dev, raw, old=None):
    """DeviceCompressedArray(entropy=True), each path with the launch counts
    set to 0 just before it and read just after: HEADLINE_MB of the
    low-cardinality column (bpp 1, slabs of 32 KiB), then the sorted int32
    headline. On both, K3, K4 and K5 are held against their plain versions
    on the full inputs of the calls the build and to_array make (the plain
    versions in slices); on the low-cardinality column they are timed
    there too, K5 also on the call of the first slab read (queued behind a
    sleep kernel and as called), and with old (load_old) K4 and K5 of the
    old design beside them."""
    d = low_card_device(dev, HEADLINE_MB * MIB)
    res = {"launches": {}}
    reset_counts()
    t0 = time.perf_counter()
    arr = stt.DeviceCompressedArray.from_array(d, entropy=True, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res["launches"]["build"] = read_counts()
    e = arr._entropy
    check(e is not None and arr._rows is None,
          "the entropy stage dropped itself on the low-cardinality column")
    plain = stt.DeviceCompressedArray.from_array(d, device=dev)
    check(arr.memory_footprint() < plain.memory_footprint(),
          "entropy footprint not below the row store's")
    reset_counts()
    t0 = time.perf_counter()
    back = arr.to_array()
    to_array_s = time.perf_counter() - t0
    res["launches"]["to_array"] = read_counts()
    check(np.array_equal(back, d), "entropy container to_array")
    del back
    rng = np.random.default_rng(5)
    reset_counts()
    t0 = time.perf_counter()
    with Capture(device_container, "decode_streams", 1) as k5r:
        for i in rng.integers(0, arr.n_slabs, 100):
            got = arr.slab(int(i)).cpu().numpy()
            check(got.tobytes() == d[i * arr.slab_bytes:
                                     (i + 1) * arr.slab_bytes].tobytes(),
                  f"entropy container slab {i}")
    slab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in rng.integers(0, len(d), 1000):
        check(arr[int(i)] == d[i], f"entropy container element {i}")
    element_s = time.perf_counter() - t0
    res["launches"]["reads"] = read_counts()
    reset_counts()
    blob = arr.serialize()
    res["launches"]["serialize"] = read_counts()
    check(blob == plain.serialize(), "entropy serialize differs from the "
          "entropy=False container's frame")
    check(np.array_equal(stt.decompress(blob, 1, device=dev), d),
          "entropy serialize -> decompress")
    del blob
    nblk = len(e.flags)
    res["lowcard"] = {
        "build_s": build_s, "to_array_s": to_array_s,
        "slab_read_ms": slab_s * 10, "element_read_ms": element_s,
        "footprint": arr.memory_footprint(),
        "ratio": arr.current_compression_ratio(),
        "plain_footprint": plain.memory_footprint(),
        "plain_ratio": plain.current_compression_ratio(),
        "bytes": len(d), "records_bytes": int(plain._totals.sum()),
        "blocks": nblk, "coded_blocks": int(e.flags.sum()),
        "wbucket": e.words.shape[1] * 4, "rb": e.rb}
    r = res["lowcard"]
    log(f"entropy container, {HEADLINE_MB} MiB low-cardinality uint8: "
        f"{r['coded_blocks']} of {nblk} blocks coded, ratio {r['ratio']:.4f} "
        f"(entropy=False {r['plain_ratio']:.4f}); build {build_s:.4f} s, "
        f"to_array {to_array_s:.4f} s, slab read {r['slab_read_ms']:.4f} ms, "
        f"element read {element_s:.4f} ms; reads and serialize == input; "
        f"launches {res['launches']}")
    err, times = {}, {}
    entropy_kernels(dev, plain, e, err, times, old)
    # K5 as a slab read calls it: the rows of the blocks the slab spans
    a5 = k5r.calls[0][0]
    err["huff_decode_streams"] = max(err["huff_decode_streams"], huff_err(
        (huff_decode_kernel.decode_streams(*a5),),
        (huff_decode_kernel.decode_streams_plain(*a5),)))
    reach = (a5[1].max(1).values.clamp(min=0) + 7) // 8
    times["huff_decode_streams"]["read_call"] = r5 = {
        **in_turns("K5 on a read's rows",
                   lambda: huff_decode_kernel.decode_streams(*a5),
                   old and (lambda: old.huff_decode_kernel.decode_streams(
                       *a5)), 20,
                   (("queued_ms", queued_ms), ("called_ms", cuda_ms))),
        "rows": a5[0].shape[0], "width": a5[0].shape[1],
        "bytes": (int(reach.clamp(max=a5[0].shape[1]).sum())
                  + a5[1].numel() * 4 + a5[2].numel() * 4
                  + a5[0].shape[0] * STREAM)}
    r5["bound_ms"] = r5["bytes"] / HBM_BYTES_PER_S * 1e3
    del arr, e, plain
    for name, t in times.items():
        t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"{name} at {HEADLINE_MB} MiB low-cardinality ({nblk} blocks): "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                        else f"{k} {v}" for k, v in t.items()))

    # the sorted int32 headline: few of its 904 blocks code, but the stage
    # has been kept in every full run (it drops the rows' padding); recorded,
    # and its kernels held as above
    a = raw.view("<u4")
    reset_counts()
    t0 = time.perf_counter()
    arr = stt.DeviceCompressedArray.from_array(a, entropy=True, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lc = res["launches"]["sorted_build"] = read_counts()
    check(lc["huff_histogram"] and lc["huff_encode_streams"],
          "K3/K4 did not run on the sorted headline")
    e = arr._entropy
    reset_counts()
    t0 = time.perf_counter()
    back = arr.to_array()
    to_array_s = time.perf_counter() - t0
    lt = res["launches"]["sorted_to_array"] = read_counts()
    check(np.array_equal(back, a), "sorted entropy to_array")
    del back
    check(e is None or lt["huff_decode_streams"],
          "K5 did not run on the sorted to_array")
    res["sorted"] = {"kept": e is not None, "build_s": build_s,
                     "to_array_s": to_array_s,
                     "ratio": arr.current_compression_ratio(),
                     "coded_blocks": 0 if e is None else int(e.flags.sum()),
                     "blocks": None if e is None else len(e.flags)}
    plain = stt.DeviceCompressedArray.from_array(a, device=dev)
    entropy_kernels(dev, plain, e, err)
    del arr, e, plain
    log(f"entropy container, {HEADLINE_MB} MiB sorted int32: "
        f"{res['sorted']}, to_array == input; launches {lc} (build), {lt} "
        "(to_array)")
    log(f"entropy kernels == plain versions at the paths' shapes: {err}")
    check(not any(err.values()), f"entropy kernels differ: {err}")
    return res, times, err


class Capture:
    """Records (clones of) the arguments of the first `limit` calls that a
    module (device_decode, zstd_frame) makes to one of its kernel wrappers,
    and passes every call on: the calls stay the path's own and count as
    its launches."""

    def __init__(self, module, name, limit):
        self.module, self.name, self.limit, self.calls = module, name, limit, []
        self.real = getattr(module, name)

    def __enter__(self):
        def spy(*args, **kw):
            if len(self.calls) < self.limit:
                self.calls.append(([a.clone() if torch.is_tensor(a) else a
                                    for a in args], dict(kw)))
            return self.real(*args, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def text_cell(nbytes):
    """benchs/data/code_text.txt repeated to nbytes (a 620,858-byte
    period)."""
    with open(TEXT_PATH, "rb") as f:
        text = np.frombuffer(f.read(), np.uint8)
    return np.resize(text, nbytes)


def methods(frame_bytes, bpp):
    """Count of each superblock method in a frame."""
    dsize, sb, pos = fr.get_info(frame_bytes, bpp)
    out = {}
    for _ in range(-(-dsize // sb)):
        code = frame_bytes[pos]
        out[code] = out.get(code, 0) + 1
        pos += 4 + int.from_bytes(frame_bytes[pos + 1 : pos + 4], "little")
    return out


def zstd_exact(name, k, p):
    """Max abs difference of tuples of integer tensors (equal shapes)."""
    for a, b in zip(k, p):
        check(a.shape == b.shape, f"{name}: shape differs from the plain "
              "version's")
    return max(int((a.long() - b.long().to(a.device)).abs().max())
               if a.numel() else 0 for a, b in zip(k, p))


def seq_decode_bytes(args):
    """K7's bytes: each section's sequences bitstream (not the rest of the
    payloads' buffer: literals, headers, sidecars), meta, tables and lanes
    in; ll, ml, offset values, offsets (16 B a sequence) and the summaries
    (32 B a section) out."""
    _, meta, tabs, lanes = args
    return (int(meta[:, 1].sum()) + meta.numel() * 8 + tabs.numel() * 4
            + lanes.numel() * 8 + 16 * int(meta[:, 3].sum())
            + 32 * meta.shape[0])


def seq_exec_bytes(args):
    """X1's bytes: host literals, the literals it reads from K5's rows,
    sequences, blocks and lanes in; the blocks' output written once."""
    out, lits, rows, ll, ml, off, blocks, lanes = args
    b = blocks.cpu()
    return (lits.numel() + int(b[b[:, 6] >= 0, 3].sum()) + 12 * ll.numel()
            + blocks.numel() * 8 + lanes.numel() * 8 + int(b[:, 1].sum()))


def fresh(args):
    """Clones of a captured call's tensors (X1 writes its out in place)."""
    return [a.clone() if torch.is_tensor(a) else a for a in args]


def frame_payloads(frame_bytes, bpp, n):
    """The first n superblocks' payloads of a frame and their sizes."""
    dsize, sb, pos = fr.get_info(frame_bytes, bpp)
    pays, sizes = [], []
    for i in range(min(n, -(-dsize // sb))):
        csize = int.from_bytes(frame_bytes[pos + 1 : pos + 4], "little")
        pays.append(frame_bytes[pos + 4 : pos + 4 + csize])
        sizes.append(min(sb, dsize - i * sb))
        pos += 4 + csize
    return pays, sizes


def k6_launch(mod, args):
    """K6's launch alone (mod: a package's fse_kernel module, this one's or
    load_old's), on fresh zeroed words: a function returning (words,
    bits). Not counted in the launches: it times and compares."""
    lib = mod._cuda.load("fse_encode", mod._SIGNATURES)
    seqs, tabs, meta = args
    words = torch.zeros(int(meta[:, 3].sum()), dtype=torch.int32,
                        device=seqs.device)
    bits = torch.zeros(meta.shape[0], dtype=torch.int64, device=seqs.device)
    stream = torch.cuda.current_stream(seqs.device).cuda_stream

    def fn():
        _cuda.check(lib.stenos_fse_encode(
            seqs.data_ptr(), tabs.data_ptr(), meta.data_ptr(), meta.shape[0],
            words.data_ptr(), bits.data_ptr(), stream), "fse_encode")
        return words, bits

    return fn


def k6_step_cycles(dev, short=8192, long=32768):
    """One serial K6 step in clock cycles (CLOCK_HZ), measured: the launch
    alone on one block of no_sync_seqs, whose three channels are each
    walked by one thread, at two lengths; the difference of the times over
    the difference of the steps, so that the launch and the parallel
    passes' fixed costs drop out."""
    ms = [cuda_ms(k6_launch(fse_kernel, fse_kernel.pack_blocks(
        [fse_kernel.prep_block(no_sync_seqs(n), FRESH_REPS)[1]], dev)), 5)
        for n in (short, long)]
    return (ms[1] - ms[0]) * 1e-3 * CLOCK_HZ / (long - short)


def k6_sync_profile(seqs, tabs, meta):
    """Per channel (LL, ML, OF): the share of K6's sequences that are sync
    points (fse_kernel.sync_states), and the longest sync-free run in walk
    steps over the blocks."""
    sync = fse_kernel.sync_states(tabs, meta).cpu().numpy()
    rows, m = seqs.cpu().numpy(), meta.cpu().numpy()
    hits, longest = np.zeros(3), np.zeros(3, np.int64)
    for b in range(len(m)):
        r = rows[m[b, 0] : m[b, 0] + m[b, 1]][::-1]
        for ch in range(3):
            at = np.flatnonzero(sync[b, ch][r[:, ch]] >= 0)
            hits[ch] += len(at)
            longest[ch] = max(longest[ch], int(np.diff(np.concatenate(
                [[0], at, [len(r)]])).max()))
    return {"sync_share": dict(zip(("ll", "ml", "of"),
                                   (hits / len(rows)).tolist())),
            "longest_sync_free_run": dict(zip(("ll", "ml", "of"),
                                              longest.tolist()))}


def phase_zstd(dev, old=None):
    """The device zstd entropy stage. (a) decode_payloads_device on one
    batch of a grid of 2-3 block payloads: device frames of literals,
    64-byte records, mixed blocks and a partial tail, and a libzstd frame at
    stenos level 9 with matches across blocks (the one-lane route). (b) The
    text cell, TEXT_MB of code text at bpp 1, level 2: compress with libzstd
    then decompress on the card, compress(entropy="device") then decompress
    on the card, each path with the launch counts set to 0 just before it
    and read just after (at most 8 launches of K5, K7 and X1 a decompress:
    one per 64 MiB chunk); no payload may go to the host ladder; both frames
    through host libzstd too; a second decompress of each frame with the
    decode's steps timed (device_decode.timing) gives the split, and the
    host pass of the first chunk runs again on 1 thread and on the pool.
    (c) K6 on the sequences of 64 of its blocks, held against
    encode_sequences and decoded back through K7. (d) K5, K6, K7 and X1
    against their plain versions on the calls of (a)-(c); K7 and X1 timed on
    the path's own call, the first 64 MiB chunk of the libzstd frame's
    decode, and K5 on that chunk's call too; K6 on (c)'s 64 blocks as
    called and its launch alone, with the blocks' sync profile and one
    serial step measured (k6_step_cycles) (with old, load_old, K5 and K6
    beside the old design's, in turns)."""
    res = {"launches": {}}
    err = {"fse_encode": 0, "seq_decode": 0, "seq_exec": 0,
           "huff_histogram": 0, "huff_encode_streams": 0,
           "huff_decode_streams": 0}
    times = {}
    rng = np.random.default_rng(11)
    text = text_cell(TEXT_MB * MIB)
    ladder0 = device_decode.host_ladder

    # (a) the tier grid, one batch
    B = 131072
    lit = rng.integers(0, 64, 3 * B).astype(np.uint8)
    rec = np.tile(rng.integers(0, 256, 64).astype(np.uint8), 3 * B // 64)
    piece = rng.integers(0, 256, 100_000).astype(np.uint8)
    grid = {"literals": lit, "records": rec,
            "mixed": np.concatenate([lit[:B], rec[:B], text[:B]]),
            "tail": np.concatenate([lit[: 2 * B], text[:5000]])}
    reset_counts()
    with Capture(zstd_frame, "histogram", 8) as k3a, \
            Capture(zstd_frame, "encode_streams", 8) as k4a:
        payloads = {k: zstd_frame.encode_frame_device(v, dev)
                    for k, v in grid.items()}
    grid["libzstd9"] = np.concatenate([np.tile(piece, 3), text[:60_000]])
    payloads["libzstd9"] = zstd_host.compress(grid["libzstd9"].tobytes(),
                                              1 << 24, 9)
    with Capture(device_decode, "decode_sections", 1) as k7a, \
            Capture(device_decode, "execute", 1) as x1a, \
            Capture(device_decode, "decode_streams", 1) as k5a:
        got = device_decode.decode_payloads_device(
            [payloads[k] for k in grid], [len(v) for v in grid.values()], dev)
    for (name, data), g in zip(grid.items(), got):
        check(g is not None and np.array_equal(g.cpu().numpy(), data),
              f"decode_payloads_device of the {name} payload")
    lg = res["launches"]["grid"] = read_counts()
    check(device_decode.host_ladder == ladder0, "a grid payload went to the "
          "host ladder")
    check(all(lg[k] for k in ("huff_histogram", "huff_encode_streams"))
          and all(lg[k] == 1 for k in ("huff_decode_streams", "seq_decode",
                                       "seq_exec")),
          f"the grid batch missed a kernel or took more than one launch: "
          f"{lg}")
    staged = x1a.calls[0][0][7][:, 2]
    check(bool(staged.any()) and not bool(staged.all()),
          "the grid batch did not take both X1 routes")
    log(f"zstd tier grid on the card ({', '.join(grid)}), one batch: "
        "decode_payloads_device == input, no payload on the host ladder; "
        f"launches {lg}")
    # a corrupt section (one sequence more than its stream holds): K7 sets
    # error bit 2, as its plain version does; it joins the plain checks
    stream, meta, tabs, _ = k7a.calls[0][0]
    bad = meta[:1].clone()
    bad[0, 3] += 1
    bad_args = [stream, bad, tabs[:1].contiguous(),
                torch.tensor([[0, 1]], device=dev)]
    check(seqdec_kernel.decode_sections(*bad_args)[4][:, 3].tolist() == [2],
          "K7 did not flag a corrupt section")
    k7_calls = [k7a.calls[0][0], bad_args]
    x1_calls = [x1a.calls[0][0]]
    k5_calls = [k5a.calls[0][0]]

    # (b) the text cell
    cell = {}
    for route, kw in (("libzstd", {}), ("device", {"entropy": "device"})):
        reset_counts()
        t0 = time.perf_counter()
        frame_b = stt.compress(text, 1, 2, device=dev, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res["launches"][f"compress_{route}"] = read_counts()
        m = methods(frame_b, 1)
        check(m == {2: TEXT_MB * 8}, f"text cell {route}: superblock "
              f"methods {m}, not all METHOD_ZSTD")
        ladder = device_decode.host_ladder
        k7 = Capture(device_decode, "decode_sections", 1)
        x1 = Capture(device_decode, "execute", 1)
        k5 = Capture(device_decode, "decode_streams", 1)
        with k7, x1, k5:
            reset_counts()
            t2 = time.perf_counter()
            back = stt.decompress(frame_b, 1, device=dev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            lc = res["launches"][f"decompress_{route}"] = read_counts()
        check(np.array_equal(back, text), f"text cell {route}: decompress "
              "on the card differs from the input")
        check(device_decode.host_ladder == ladder, f"text cell {route}: "
              f"{device_decode.host_ladder - ladder} payloads went to the "
              "host ladder")
        nchunk = -(-TEXT_MB * MIB // CHUNK_BYTES)
        check(all(lc[k] == nchunk for k in ("huff_decode_streams",
                                            "seq_decode", "seq_exec")),
              f"text cell {route}: not one launch of K5, K7 and X1 a "
              f"{CHUNK_BYTES // MIB} MiB chunk: {lc}")
        del back
        # the split: the same decompress with each step timed
        device_decode.timing = {}
        t4 = time.perf_counter()
        stt.decompress(frame_b, 1, device=dev)
        t5 = time.perf_counter()
        split = {k: v * 1e3 for k, v in device_decode.timing.items()}
        device_decode.timing = None
        split["total"] = (t5 - t4) * 1e3
        split["rest"] = split["total"] - sum(v for k, v in split.items()
                                             if k != "total")
        pays, sizes = frame_payloads(frame_b, 1, CHUNK_BYTES // B)
        lens = [len(p) for p in pays]
        buf = np.frombuffer(b"".join(pays) + b"\0" * 4, np.uint8)
        # the host pass of the first chunk on one thread and as decompress
        # runs it (up to HOST_THREADS, one a 8 anchor scans): the median
        # of 3 each, ms a superblock
        threads = {}
        for n in (1, staging.HOST_THREADS):
            reps = []
            for _ in range(3):
                t6 = time.perf_counter()
                scans = native.load().zstd_prep_batch(
                    buf, np.cumsum([0] + lens[:-1]), lens, sizes, n,
                    4 * huff_kernel.WOUT_WORDS)[-1]
                reps.append((time.perf_counter() - t6) * 1e3 / len(pays))
            threads[n] = sorted(reps)[1]
        t0h = time.perf_counter()
        host_back = stt.decompress(frame_b, 1, engine=None)
        host_s = time.perf_counter() - t0h
        check(np.array_equal(host_back, text), f"text cell {route}: the frame "
              "does not decode through host libzstd")
        cell[route] = {"bytes": len(frame_b),
                       "ratio": len(text) / len(frame_b),
                       "compress_s": t1 - t0, "decompress_s": t3 - t2,
                       "compress_gbps": len(text) / (t1 - t0) / 1e9,
                       "decompress_gbps": len(text) / (t3 - t2) / 1e9,
                       "host_libzstd_decompress_s": host_s,
                       "split_ms": split,
                       "split_ms_per_superblock": {
                           k: v / (TEXT_MB * 8) for k, v in split.items()},
                       "host_pass_ms_per_superblock_by_threads": threads,
                       "anchor_scans_first_chunk": scans,
                       "k7_call": k7.calls[0][0], "x1_call": x1.calls[0][0],
                       "k5_call": k5.calls[0][0]}
        del host_back, frame_b
        c = cell[route]
        log(f"text cell {TEXT_MB} MiB code text, bpp 1, level 2, zstd stage "
            f"{route}: ratio {c['ratio']:.4f}, compress "
            f"{c['compress_s']:.3f} s = {c['compress_gbps']:.4f} GB/s, "
            "decompress on the card "
            f"{c['decompress_s']:.3f} s = {c['decompress_gbps']:.4f} GB/s "
            f"(== input, 0 payloads on the host ladder), through host "
            f"libzstd {host_s:.3f} s; launches compress "
            f"{res['launches'][f'compress_{route}']}, decompress {lc}")
        log("  split of a second decompress, ms: " + ", ".join(
            f"{k} {v:.1f}" for k, v in split.items())
            + f"; host pass of the first chunk, ms a superblock by threads: "
            f"{threads}")

    # (c) K6 on the sequences of 64 text blocks (device candidates, native
    # parse), then decoded back through K7 (one lane a section)
    nb = min(64, len(text) // B)
    blocks = torch.from_numpy(text[: nb * B].reshape(nb, B).copy()).to(dev)
    cand = match_candidates(blocks).cpu().numpy()
    lib = native.load()
    seqs = [lib.match_parse(text[i * B : (i + 1) * B], cand[i])[0]
            for i in range(nb)]
    reset_counts()
    secs = fse_kernel.encode_sequences_device_batch(seqs, [FRESH_REPS] * nb,
                                                    dev)
    res["launches"]["fse_entry"] = read_counts()
    check(res["launches"]["fse_entry"]["fse_encode"] == 1, "K6 did not run")
    for i in range(nb):
        check(secs[i] == encode_sequences(seqs[i], reps=FRESH_REPS),
              f"K6 section {i} differs from encode_sequences")
    preps = [seqdec_kernel.prep_section(sec, lib.zstd_ctx()) for sec in secs]
    k7c = seqdec_kernel.pack_sections(preps, dev, [1] * nb)
    ll, ml, _, off, summ = seqdec_kernel.decode_sections(*k7c)
    check(not summ[:, 3].any(), "K7 flagged a K6 section")
    ll, ml, off = (t.cpu().numpy() for t in (ll, ml, off))
    s0 = 0
    for i, p in enumerate(preps):
        n = p["nseq"]
        a = np.asarray(seqs[i])
        check(np.array_equal(ll[s0 : s0 + n], a[:, 0])
              and np.array_equal(ml[s0 : s0 + n], a[:, 2])
              and np.array_equal(off[s0 : s0 + n], a[:, 1] - 3),
              f"K6 section {i} does not decode back to its sequences")
        s0 += n
    nseq_c = s0
    k7_calls.append(list(k7c))
    log(f"K6 on {nb} text blocks ({nseq_c} sequences): sections == "
        "encode_sequences, K7 gives the sequences and offsets back")

    # (d) plain versions, and times. K3 and K4 on the grid's literal-only
    # blocks (encode_frame_device's calls), K5 on the grid's batch and the
    # first chunk of each text-cell decode: each call again through the
    # kernel, against its plain version on the same inputs
    for args, kw in k3a.calls:
        err["huff_histogram"] = max(err["huff_histogram"], huff_err(
            (huff_kernel.histogram(*args, **kw),),
            (huff_kernel.histogram_plain(*args, **kw),)))
    for args, kw in k4a.calls:
        err["huff_encode_streams"] = max(err["huff_encode_streams"], huff_err(
            huff_kernel.encode_streams(*args, **kw),
            huff_kernel.encode_streams_plain(*args, **kw)))
    k5_calls += [c["k5_call"] for c in cell.values()]
    for args in k5_calls:
        err["huff_decode_streams"] = max(err["huff_decode_streams"], huff_err(
            (huff_decode_kernel.decode_streams(*args),),
            (huff_decode_kernel.decode_streams_plain(*args),)))
    check(k3a.calls and k4a.calls, "no K3/K4 call on the grid")
    # K5 as the text cell's decode calls it: the first chunk's rows, as wide
    # as their longest stream
    a5 = cell["libzstd"]["k5_call"]
    _, p5_ms = timed(lambda: huff_decode_kernel.decode_streams_plain(*a5))
    k5t = res["k5_text_call"] = {
        **in_turns("K5 on a text chunk",
                   lambda: huff_decode_kernel.decode_streams(*a5),
                   old and (lambda: old.huff_decode_kernel.decode_streams(
                       *a5)), 10),
        "plain_ms": p5_ms, "rows": a5[0].shape[0], "width": a5[0].shape[1],
        "bytes": (a5[0].numel() + a5[1].numel() * 4 + a5[2].numel() * 4
                  + a5[0].shape[0] * STREAM)}
    k5t["bound_ms"] = k5t["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"K3 ({len(k3a.calls)} calls), K4 ({len(k4a.calls)}) on the grid and "
        f"K5 ({len(k5_calls)}) on the grid and the text decodes' first "
        f"chunks == plain versions; K5 on one text chunk: {k5t}")
    k6_args = fse_kernel.pack_blocks(
        [fse_kernel.prep_block(sq, FRESH_REPS)[1] for sq in seqs], dev)
    k6_out = fse_kernel.encode_bitstreams(*k6_args)
    p, p_ms = timed(lambda: fse_kernel.encode_bitstreams_plain(*k6_args))
    err["fse_encode"] = zstd_exact("K6", k6_out, p)
    del p
    # ms: the wrapper as a caller runs it (the words zeroed, the launch,
    # bits read back), as the other kernels are timed; launch_ms: the
    # launch alone on words zeroed once (k6_launch)
    k6 = in_turns("K6 on 64 text blocks",
                  lambda: fse_kernel.encode_bitstreams(*k6_args),
                  old and (lambda: old.fse_kernel.encode_bitstreams(
                      *k6_args)), 5)
    k6l = in_turns("K6's launch on 64 text blocks",
                   k6_launch(fse_kernel, k6_args),
                   old and k6_launch(old.fse_kernel, k6_args), 5,
                   timers=(("launch_ms", cuda_ms),))
    longest = int(k6_args[2][:, 1].max())
    times["fse_encode"] = {
        **k6, **k6l, "plain_ms": p_ms,
        "bytes": (sum(a.numel() * a.element_size() for a in k6_args)
                  + int(k6_out[1].sum()) // 8 + 8 * nb),
        "blocks": nb, "sequences": nseq_c, "longest_block": longest,
        **k6_sync_profile(*k6_args)}
    # the serial chains at the step measured here (k6_step_cycles): the
    # longest block walked by one thread (one thread a block, or no sync
    # point), and the longest sync-free run (the kernel's A2)
    t6 = times["fse_encode"]
    t6["step_cycles"] = k6_step_cycles(dev)
    t6["chain_bound_ms"] = longest * t6["step_cycles"] / CLOCK_HZ * 1e3
    t6["run_bound_ms"] = (max(t6["longest_sync_free_run"].values())
                          * t6["step_cycles"] / CLOCK_HZ * 1e3)
    # K7 and X1 on every captured call, against the plain versions; the
    # libzstd frame's first chunk is timed
    k7_calls += [c["k7_call"] for c in cell.values()]
    x1_calls += [c["x1_call"] for c in cell.values()]
    plain_ms = {}
    for a7 in k7_calls:
        p, p_ms = timed(lambda: seqdec_kernel.decode_sections_plain(*a7))
        plain_ms[id(a7)] = p_ms
        err["seq_decode"] = max(err["seq_decode"], zstd_exact(
            "K7", seqdec_kernel.decode_sections(*a7), p))
        del p
    for a1 in x1_calls:
        got = seq_exec.execute(*fresh(a1))
        p, p1_ms = timed(lambda: seq_exec.execute_plain(*fresh(a1)))
        plain_ms[id(a1)] = p1_ms
        err["seq_exec"] = max(err["seq_exec"], zstd_exact("X1", (got,), (p,)))
        del got, p
    log(f"K7 ({len(k7_calls)} calls) and X1 ({len(x1_calls)} calls) on the "
        "grid batch, the K6 sections, a corrupt section and the text "
        "decodes' first chunks: max abs err vs the plain versions "
        f"{err['seq_decode']}, {err['seq_exec']}")
    a7 = cell["libzstd"]["k7_call"]
    times["seq_decode"] = {
        "ms": cuda_ms(lambda: seqdec_kernel.decode_sections(*a7), 10),
        "plain_ms": plain_ms[id(a7)],
        "bytes": seq_decode_bytes(a7), "lanes": a7[3].shape[0],
        "sections": a7[1].shape[0], "sequences": int(a7[1][:, 3].sum()),
        "longest_section": int(a7[1][:, 3].max())}
    a1 = cell["libzstd"]["x1_call"]
    x1 = fresh(a1)
    times["seq_exec"] = {
        "ms": cuda_ms(lambda: seq_exec.execute(*x1), 10),
        "plain_ms": plain_ms[id(a1)], "bytes": seq_exec_bytes(a1),
        "lanes": a1[7].shape[0], "blocks": a1[6].shape[0],
        "staged_lanes": int(a1[7][:, 2].sum()), "sequences": a1[3].numel()}
    # X1's literal pass alone: the same call with every match length and
    # offset 0 and each block as long as its literals (the match pass then
    # copies nothing)
    x1z = fresh(a1)
    x1z[4].zero_()
    x1z[5].zero_()
    x1z[6][:, 1] = x1z[6][:, 3]
    seq_exec.execute_plain(*fresh(x1z))  # a valid call: the plain one takes it
    times["seq_exec"]["literal_pass_ms"] = cuda_ms(
        lambda: seq_exec.execute(*x1z), 10)
    del x1z
    check(not any(err.values()), f"zstd kernels differ: {err}")
    for name, t in times.items():
        t["bound_ms"] = t["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"{name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                    else f"{k} {v}" for k, v in t.items()))
    for c in cell.values():
        del c["k7_call"], c["x1_call"], c["k5_call"]
    res["text_cell"] = cell
    return res, times, err


# phase_grid: the sweep's frame grid (tools/validate_cuda.py) on a subset,
# and its device closed loop at these bpp
PHASE_GRID = {"bpps": (1, 3, 4, 16, 300), "kinds": KINDS,
              "sizes": (100, 70_001, 400_000), "levels": (0, 1, 5, 9)}
GRID_LOOP_BPPS = (1, 3, 4, 16, 24, 300)
ENTROPY_FRAME_MB = 4  # phase_entropy_frames: 4 MiB of text, 4 of literals


def phase_grid(dev, raw, frame):
    """The sweep's grid on a subset (tools/validate_cuda.py: the card's
    frames against the host path's, both decodes, decompress_frame_batched
    on the level-1 frames and a custom_shift frame a bpp) after its device
    closed loop, one counted path; then decompress_frame_batched(
    keep_device=True) of the headline's level-1 frame (raw, frame: one
    tensor and one K2 launch a CHUNK_BYTES batch, so the two sets of parse
    buffers take turns), its tensors held against the data, timed in turns
    beside stt.decompress of the same frame."""
    res = {"launches": {}}
    reset_counts()
    t0 = time.perf_counter()
    loop_failed = vc.closed_loop(dev, GRID_LOOP_BPPS, log=log)
    g = vc.grid(dev, **PHASE_GRID, log=lambda m: None)
    res["launches"]["parity_grid"] = read_counts()
    res["grid"] = {"seconds": time.perf_counter() - t0, "loop_bpps":
                   GRID_LOOP_BPPS, **PHASE_GRID,
                   **{k: g[k] for k in ("cases", "fails", "batched",
                                        "failed")}}
    log(f"grid: device closed loop at bpp {GRID_LOOP_BPPS} "
        f"({len(loop_failed)} failed), {g['cases']} frames ({g['fails']} "
        f"failed; decompress_frame_batched decoded {g['batched'][0]}, None "
        f"for {g['batched'][1]}) in {res['grid']['seconds']:.1f} s, "
        f"launches {res['launches']['parity_grid']}")
    for line in g["failed"]:
        log(f"  {line}")
    check(not loop_failed and not g["fails"],
          f"grid: closed loop failed at {loop_failed}, {g['fails']} frames")
    check(g["batched"][0] > 0, "grid: no frame through "
          "decompress_frame_batched")
    gl = res["launches"]["parity_grid"]
    check(all(gl[k] for k in ("encode_blocks", "encode_blocks_index",
                              "decode_rows", "decode_rows_derive")),
          f"grid: K1, K1b, K2 or K2b did not run: {gl}")

    check(vc.batched_expected(frame, 4), "the headline's level-1 frame is "
          "not all METHOD_BLOCK superblocks")
    reset_counts()
    outs = eng.decompress_frame_batched(frame, 4, device=dev,
                                        keep_device=True)
    res["launches"]["decompress_frame_batched"] = read_counts()
    kl = res["launches"]["decompress_frame_batched"]
    want = torch.from_numpy(raw).to(dev)
    check(outs is not None and all(t.device.type == dev.type for t in outs)
          and torch.equal(torch.cat(outs), want),
          "decompress_frame_batched(keep_device=True): tensors differ from "
          "the data")
    n_batch = -(-len(raw) // CHUNK_BYTES)
    check(n_batch > 2 and len(outs) == n_batch
          and kl["decode_rows"] == n_batch,
          f"decompress_frame_batched: {len(outs)} tensors of {n_batch} "
          f"batches, launches {kl}")
    del outs, want
    check(np.array_equal(eng.decompress_frame_batched(frame, 4, device=dev),
                         raw), "decompress_frame_batched: numpy output")
    t = in_turns_s({
        "keep_device": lambda: eng.decompress_frame_batched(
            frame, 4, device=dev, keep_device=True),
        "decompress": lambda: stt.decompress(frame, 4, device=dev)},
        rounds=2, events=True)
    res["batched"] = {"mb": len(raw) // MIB, "frame_bytes": len(frame),
                      "tensors": n_batch, **t}
    log(f"{len(raw) // MIB} MiB level-1 frame: decompress_frame_batched("
        f"keep_device=True) {t['keep_device'] * 1e3:.2f} ms host / "
        f"{t['keep_device_events'] * 1e3:.2f} ms events, stt.decompress "
        f"{t['decompress'] * 1e3:.2f} / {t['decompress_events'] * 1e3:.2f} "
        f"ms (means of 4, in turns); launches {kl}")
    return res


def phase_entropy_frames(dev):
    """encode_frame_device(sidecar=False) and STENOS_SEQ_ANCHORS=0 on the
    text cell's first 4 MiB (blocks with sequences) and 4 MiB of bytes
    below 64 (literal blocks: K3, K4). A sidecar=False frame is the default
    frame without its sidecar; under STENOS_SEQ_ANCHORS=0 the text's
    sidecar changes (its blocks lose their anchors) and the literals' does
    not. Every frame decodes on the card (decode_payload_device, no payload
    to the host ladder) and through host libzstd to the data. Each variant
    is a counted path."""
    n = ENTROPY_FRAME_MB * MIB
    g = torch.Generator(device=dev).manual_seed(5)
    data = {"text": text_cell(n),
            "literals": torch.randint(0, 64, (n,), generator=g, device=dev,
                                      dtype=torch.uint8).cpu().numpy()}
    full = {k: zstd_frame.encode_frame_device(d, dev)
            for k, d in data.items()}
    bare = {}
    res = {"launches": {}, "frames": {}}
    for path, env, sidecar in (("sidecar_false", None, False),
                               ("seq_anchors_0", "0", True)):
        old = os.environ.pop("STENOS_SEQ_ANCHORS", None)
        if env is not None:
            os.environ["STENOS_SEQ_ANCHORS"] = env
        ladder = device_decode.host_ladder
        reset_counts()
        t0 = time.perf_counter()
        try:
            for name, d in data.items():
                f = zstd_frame.encode_frame_device(d, dev, sidecar=sidecar)
                out = device_decode.decode_payload_device(f, len(d), dev)
                check(out is not None and torch.equal(
                    out, torch.from_numpy(d).to(dev)),
                    f"{path} {name}: the card's decode differs")
                check(zstd_host.decompress(f, len(d)) == d.tobytes(),
                      f"{path} {name}: host libzstd's decode differs")
                if not sidecar:
                    bare[name] = f
                    check(full[name][: len(f)] == f
                          and len(full[name]) > len(f),
                          f"{path} {name}: not the default frame without "
                          "its sidecar")
                else:
                    check(f.startswith(bare[name])
                          and (f != full[name]) == (name == "text"),
                          f"{path} {name}: the sidecar did not change as "
                          "expected")
                res["frames"][f"{path}.{name}"] = {
                    "bytes": len(f), "default_bytes": len(full[name])}
        finally:
            os.environ.pop("STENOS_SEQ_ANCHORS", None)
            if old is not None:
                os.environ["STENOS_SEQ_ANCHORS"] = old
        res["launches"][path] = read_counts()
        res[f"{path}_s"] = time.perf_counter() - t0
        check(device_decode.host_ladder == ladder,
              f"{path}: a payload went to the host ladder")
        log(f"entropy frames, {path}: {res[f'{path}_s']:.2f} s, launches "
            f"{res['launches'][path]}")
    log(f"  frame bytes: {res['frames']}")
    pl = res["launches"]
    check(all(pl["sidecar_false"][k] for k in (
        "huff_histogram", "huff_encode_streams", "huff_decode_streams",
        "seq_decode", "seq_exec")) and all(pl["seq_anchors_0"][k] for k in (
            "huff_decode_streams", "seq_decode", "seq_exec")),
          f"entropy frames: a kernel did not run on its path: {pl}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    ap.add_argument("--old-src", help="a checkout of an earlier commit: its "
                    "K2/K2b, K4, K5 and K6 kernels and its device frame "
                    "compress (with its launch path's host split), K1 and "
                    "place_records are timed beside these, in turns")
    ap.add_argument("--gloo-rank", type=int, help="run one of "
                    "phase_sharding's two gloo ranks (phase_sharding starts "
                    "them) and print its JSON line")
    ap.add_argument("--port", type=int, help="the gloo ranks' port")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.gloo_rank is not None:
        return gloo_rank(args.gloo_rank, args.port)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    card = phase_build()
    err_small = phase_kernels(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    phase_host_frames(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    colres = {"frames": phase_frames(dev)}
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    raw, res = phase_headline(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    times, err = phase_timing(dev, raw, res[1]["frame"], res[2]["frame"])
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    cres, err_ctx = phase_context(dev, raw, res[1]["frame"],
                                  res[1]["compress_s"])
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    for name, e in err_ctx.items():
        err[name] = max(err[name], e)
    sres, err_sh = phase_sharding(dev, raw, {lvl: r["frame"]
                                             for lvl, r in res.items()}, card)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    for name, e in err_sh.items():
        err[name] = max(err[name], e)
    dres, times_dev, err_dev = phase_device(dev, raw, res[1]["frame"])
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    colres.update(phase_column(dev))
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    colres["fold"] = phase_fold(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    colres["launch"] = phase_launch(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    times.update(times_dev)
    err["encode_blocks"] = max(err["encode_blocks"],
                               err_dev.pop("encode_blocks"))
    err.update(err_dev)
    old = load_old(args.old_src) if args.old_src else None
    if old is not None:
        colres["launch_times"] = phase_launch_times(dev, old)
        log(f"  [{time.perf_counter() - t0:.1f} s]")
    dtimes = phase_decode_times(dev, raw, res[1]["frame"], old)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    for name, main_case in (("decode_rows", "k2_64mib"),
                            ("decode_rows_derive", "k2b_jb_512mib")):
        times[name].update(
            {k: dtimes[main_case][k] for k in ("ms", "bound_ms", "bound_by",
                                              "bytes")},
            shapes={k: v for k, v in dtimes.items()
                    if k.startswith("k2b_" if "derive" in name else "k2_")})
    eres, times_ent, err_ent = phase_entropy(dev, raw, old)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    times.update(times_ent)
    err.update(err_ent)
    zres, times_z, err_z = phase_zstd(dev, old)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    times.update(times_z)
    for name, e in err_z.items():
        err[name] = max(err.get(name, 0), e)
    gres = phase_grid(dev, raw, res[1]["frame"])
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    efres = phase_entropy_frames(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")

    # (source, TPU kernel it replaces, launches on its own path, by path);
    # K1 and K2 also run on the context phase's paths (timed, generic,
    # threads, auto, the container's chunks) and the sharded ones
    by_level = ({f"level {lvl}": r["launches"] for lvl, r in res.items()}
                | cres["launches"] | sres["launches"] | gres["launches"])
    pgrid = {"parity_grid": gres["launches"]["parity_grid"]}
    dl = dres["launches"] | pgrid
    # K3, K4 and K5 also run on the zstd stage's paths; K5, K7 and X1 on
    # the parity grid's and the entropy frames' too
    zpaths = zres["launches"] | efres["launches"] | pgrid
    huff_paths = {**eres["launches"], **zpaths}
    replaces = {
        "encode_blocks": ("stenos_tpu_torch/csrc/encode_blocks.cu",
                          "stenos_tpu/ops/encode_pallas.py:188",
                          res[1]["launches"],
                          {**by_level,
                           "frame_compress": dl["frame_compress"]}),
        "encode_blocks_index": ("stenos_tpu_torch/csrc/encode_blocks.cu",
                                "stenos_tpu/ops/encode_pallas.py:389",
                                dl["roundtrip"], dl),
        "decode_rows": ("stenos_tpu_torch/csrc/decode_rows.cu",
                        "stenos_tpu/ops/decode_pallas.py:127",
                        res[1]["launches"], by_level),
        "decode_rows_derive": ("stenos_tpu_torch/csrc/decode_rows.cu",
                               "stenos_tpu/ops/decode_pallas.py:133",
                               dl["roundtrip"], dl),
        "huff_histogram": ("stenos_tpu_torch/csrc/huff_encode.cu",
                           "stenos_tpu/entropy/huff_pallas.py:228",
                           eres["launches"]["build"], huff_paths),
        "huff_encode_streams": ("stenos_tpu_torch/csrc/huff_encode.cu",
                                "stenos_tpu/entropy/huff_pallas.py:90",
                                eres["launches"]["build"], huff_paths),
        "huff_decode_streams": ("stenos_tpu_torch/csrc/huff_decode.cu",
                                "stenos_tpu/entropy/huff_decode_pallas.py:626",
                                eres["launches"]["to_array"], huff_paths),
        "fse_encode": ("stenos_tpu_torch/csrc/fse_encode.cu",
                       "stenos_tpu/entropy/fse_pallas.py:76",
                       zres["launches"]["fse_entry"], zpaths),
        "seq_decode": ("stenos_tpu_torch/csrc/seq_decode.cu",
                       "stenos_tpu/entropy/seqdec_pallas.py:75",
                       zres["launches"]["decompress_device"], zpaths),
        "seq_exec": ("stenos_tpu_torch/csrc/seq_exec.cu",
                     "stenos_tpu/entropy/seq_exec.py:67",
                     zres["launches"]["decompress_device"], zpaths),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": main_path[name],
        "launches_by_path": {k: v[name] for k, v in paths.items()},
        "max_abs_err": max(err[name], err_small[name]),
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name].get("bound_by", "bytes"),
        "library_ms": times[name].get("library_ms"),
    } for name, (src, rep, main_path, paths) in replaces.items()]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} did not run on its path")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    record = {"card": card, "device": device, "headline_mb": HEADLINE_MB,
              "headline": {lvl: {k: v for k, v in r.items() if k != "frame"}
                           for lvl, r in res.items()},
              "device_paths": dres, "columns": colres, "context": cres,
              "sharding": sres,
              "entropy": eres, "grid": gres, "entropy_frames": efres,
              "zstd": zres,
              "timing": times,
              "kernels": kernels}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
