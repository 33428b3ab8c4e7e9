#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out chiprun_out/chip_smoke.json]

Builds the encode_blocks and decode_rows kernels from stenos_tpu_torch/csrc
(and the native host runtime), holds each kernel against its plain torch
version on the card, checks 32 MiB frames byte for byte against the numpy
host path, then drives the main path -- compress / decompress of 512 MiB of
sorted int32 (bytesoftype 4) at levels 1 and 2 -- holds each kernel against
its plain version again at the shapes that path gives it, times the kernels
with CUDA events and prints the kernels' JSON line. Any failure
ends the run with a non-zero exit code. The last line is
{"ok": true, "device": {...}}.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import stenos_tpu_torch as stt
from stenos_tpu_torch import frame as fr
from stenos_tpu_torch import native
from stenos_tpu_torch.host import zstd as zstd_host
from stenos_tpu_torch.engine import CHUNK_BYTES
from stenos_tpu_torch.ops import _cuda, decode_kernel, encode_kernel

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MIB = 1024 * 1024
HEADLINE_MB = 512  # bench.py's headline size
KINDS = ("sorted", "random", "same", "rle", "smallrange")


def gen_elements(rng, bpp, nelem, kind):
    """The test suite's data generators (tests/conftest.py)."""
    hi = 1 << min(8 * bpp - 1, 60)
    if kind == "sorted":
        a = np.sort(rng.integers(0, hi, nelem))
    elif kind == "random":
        a = rng.integers(0, hi, nelem)
    elif kind == "same":
        a = np.full(nelem, 123456789 % hi)
    elif kind == "rle":
        a = np.repeat(rng.integers(0, 255, max(1, nelem // 37) + 1), 37)[:nelem]
    else:
        a = rng.integers(1000, 1032, nelem)
    if bpp in (1, 2, 4, 8):
        return np.frombuffer(a.astype(f"<u{bpp}").tobytes(), np.uint8)
    # wider elements: little-endian value bytes, zero-extended past 8
    b8 = np.frombuffer(a.astype("<u8").tobytes(), np.uint8).reshape(nelem, 8)
    out = np.zeros((nelem, bpp), np.uint8)
    out[:, : min(bpp, 8)] = b8[:, : min(bpp, 8)]
    return out.reshape(-1)


def sorted_int32(nbytes, seed=42):
    """bench.py's headline data: sorted uint32 values below 2**30."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, 1 << 30, nbytes // 4, dtype=np.int64))
    return a.astype(np.uint32).view(np.uint8)


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


def encode_err(k, p):
    """Max abs difference of the kernel's and the plain version's encode
    outputs over each stream's first totals bytes; the sizes must agree."""
    for a, b in zip(k[1:], p[1:]):
        check(torch.equal(a, b), "encode sizes differ from the plain version")
    w = min(k[0].shape[1], p[0].shape[1])
    valid = torch.arange(w, device=k[1].device) < k[1][:, None]
    d = (k[0][:, :w].int() - p[0][:, :w].int()).abs()[valid]
    return int(d.max()) if d.numel() else 0


def decode_err(k, p):
    check(k.shape == p.shape, "decode shape differs from the plain version")
    return int((k.int() - p.int()).abs().max())


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
        _cuda.build(["encode_blocks", "decode_rows"])
        host.result()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc x2 + g++, in parallel)")
    for name in ("encode_blocks", "decode_rows"):
        with open(os.path.join(_cuda.BUILD_DIR, f"{name}.ptxas.txt")) as f:
            for line in f:
                if "registers" in line or "Compiling entry" in line:
                    log(f"  ptxas {name}: {line.strip()}")
    return card


def phase_kernels(dev):
    """Each kernel against its plain version on the card, byte for byte."""
    rng = np.random.default_rng(2024)
    err = {"encode_blocks": 0, "decode_rows": 0}
    n = 0
    for bpp, n_sb, kind in itertools.product(
            (1, 2, 3, 4, 8, 16, 24, 300), (3, 1), KINDS):
        sb = fr.super_block_size(256 * bpp)
        raw = gen_elements(rng, bpp, n_sb * sb // bpp, kind)
        x = torch.from_numpy(raw.copy()).to(dev).view(n_sb, sb)
        for level in (1, 2):
            k = encode_kernel.encode_superblocks(x, bpp, level)
            p = encode_kernel.encode_superblocks_plain(x, bpp, level)
            err["encode_blocks"] = max(err["encode_blocks"], encode_err(k, p))
            check(err["encode_blocks"] == 0, ("encode", bpp, kind, level))

            frame = fr.compress(raw, bpp, level, engine=None)
            sbs, streams = block_streams(frame, bpp)
            if not streams:
                continue
            vb, po, rt, _ = parsed_index(streams, bpp, sbs)
            args = [torch.from_numpy(a).to(dev) for a in (vb, po, rt)]
            nb = sbs // (256 * bpp)
            err["decode_rows"] = max(err["decode_rows"], decode_err(
                decode_kernel.decode_rows(*args, bpp, nb),
                decode_kernel.decode_rows_plain(*args, bpp, nb)))
            check(err["decode_rows"] == 0, ("decode", bpp, kind, level))
            n += 1
    log(f"kernels == plain versions on the card: {n} cases over bpp "
        "1,2,3,4,8,16,24,300 x 3 and 1 superblocks x 5 kinds x levels 1,2 "
        "(max abs err 0)")
    return err


def phase_frames(dev):
    raw = sorted_int32(32 * MIB, seed=7)
    for level in (1, 2):
        want = fr.compress(raw, 4, level, engine=None)
        got = stt.compress(raw, 4, level, device=dev)
        check(got == want, f"32 MiB level {level}: frame differs from host")
        back = stt.decompress(got, 4, device=dev)
        check(np.array_equal(back, raw), f"32 MiB level {level}: round trip")
    log("32 MiB sorted int32, levels 1 and 2: frames == host path, "
        "round trip ok")


def phase_headline(dev):
    """The main path at each level, with the launch counts set to 0 just
    before it and read just after."""
    raw = sorted_int32(HEADLINE_MB * MIB)
    res = {}
    for level in (1, 2):
        encode_kernel.launches = 0
        decode_kernel.launches = 0
        torch.cuda.synchronize()
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
            "launches": {"encode_blocks": encode_kernel.launches,
                         "decode_rows": decode_kernel.launches},
        }
        r = res[level]
        check(all(r["launches"].values()),
              f"level {level}: a kernel did not run: {r['launches']}")
        log(f"headline {HEADLINE_MB} MiB sorted int32 level {level}: ratio "
            f"{r['ratio']:.4f}, compress {r['compress_s']:.3f} s = "
            f"{r['compress_gbps']:.4f} GB/s, decompress {r['decompress_s']:.3f}"
            f" s = {r['decompress_gbps']:.4f} GB/s, launches {r['launches']}")
    return raw, res


def phase_timing(dev, raw, frame1, frame2):
    """Each kernel against its plain version, and their times and transfer
    times, at the shapes the main path gives them: one CHUNK_BYTES call of
    128 KiB superblocks (encode, level-1 decode) and one superblock (level-2
    decode)."""
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
    p_ms = cuda_ms(lambda: encode_kernel.encode_superblocks_plain(x, 4, 2), 2)
    moved = (x.numel() + int(enc[1].sum()) + 4 * (enc[2].numel()
                                                  + enc[3].numel() + per_call))
    out["encode_blocks"] = {"ms": k_ms, "plain_ms": p_ms,
                            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                            "bytes": moved}
    h2d = cuda_ms(lambda: host.to(dev), 5)
    d2h = cuda_ms(lambda: enc[0].cpu(), 5)
    out["encode_blocks"].update(h2d_ms=h2d, d2h_ms=d2h,
                                streams_bytes=enc[0].numel())

    sbs, streams = block_streams(frame1, 4)
    streams = streams[:per_call]
    t0 = time.perf_counter()
    vb, po, rt, vlens = parsed_index(streams, 4, sbs)
    parse_s = time.perf_counter() - t0
    args = [torch.from_numpy(a).to(dev) for a in (vb, po, rt)]
    nb = sbs // 1024
    err["decode_rows"] = decode_err(decode_kernel.decode_rows(*args, 4, nb),
                                    decode_kernel.decode_rows_plain(*args, 4,
                                                                    nb))
    # level 2 decodes one superblock per launch
    for s in block_streams(frame2, 4)[1][:4]:
        one = [torch.from_numpy(a).to(dev)
               for a in parsed_index([s], 4, sbs)[:3]]
        err["decode_rows"] = max(err["decode_rows"], decode_err(
            decode_kernel.decode_rows(*one, 4, nb),
            decode_kernel.decode_rows_plain(*one, 4, nb)))
    check(err["decode_rows"] == 0, "decode at the main path's shapes")
    k_ms = cuda_ms(lambda: decode_kernel.decode_rows(*args, 4, nb), 10)
    p_ms = cuda_ms(lambda: decode_kernel.decode_rows_plain(*args, 4, nb), 2)
    moved = (int(vlens.sum()) + po.nbytes + rt.nbytes + len(streams) * sbs)
    h2d = cuda_ms(lambda: [torch.from_numpy(a).to(dev) for a in (vb, po, rt)],
                  5)
    dec = decode_kernel.decode_rows(*args, 4, nb)
    d2h = cuda_ms(lambda: dec.cpu(), 5)
    out["decode_rows"] = {"ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                          "bytes": moved, "parse_ms": parse_s * 1e3,
                          "h2d_ms": h2d, "d2h_ms": d2h}
    for name, t in out.items():
        log(f"{name} at {len(chunk) // MIB} MiB: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    log(f"kernels == plain versions at the main path's shapes: {err}")
    return out, err


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/chip_smoke.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    card = phase_build()
    err_small = phase_kernels(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    phase_frames(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    raw, res = phase_headline(dev)
    log(f"  [{time.perf_counter() - t0:.1f} s]")
    times, err = phase_timing(dev, raw, res[1]["frame"], res[2]["frame"])
    log(f"  [{time.perf_counter() - t0:.1f} s]")

    replaces = {
        "encode_blocks": ("stenos_tpu_torch/csrc/encode_blocks.cu",
                          "stenos_tpu/ops/encode_pallas.py:188"),
        "decode_rows": ("stenos_tpu_torch/csrc/decode_rows.cu",
                        "stenos_tpu/ops/decode_pallas.py:127"),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": res[1]["launches"][name],
        "launches_by_level": {lvl: r["launches"][name]
                              for lvl, r in res.items()},
        "max_abs_err": max(err[name], err_small[name]),
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    } for name, (src, rep) in replaces.items()]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    record = {"card": card, "device": device, "headline_mb": HEADLINE_MB,
              "headline": {lvl: {k: v for k, v in r.items() if k != "frame"}
                           for lvl, r in res.items()},
              "timing": times, "kernels": kernels}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
