#!/usr/bin/env python
"""The port's compiled-kernel sweep on a CUDA card.

Every path of stenos_tpu_torch against the port's own host path
(frame.compress / frame.decompress with engine=None, numpy and host
libzstd):

  1. the device closed loop (roundtrip_device, block level 2, 8
     superblocks) at every bytesoftype 1-16, 24 and 300 (K1b, K2b);
  2. compress_device_sharded at a world of 1 (NCCL on the card, gloo on
     the CPU), equal to the host frame;
  3. a device-entropy frame (compress(..., entropy="device"), level 2)
     decoded by host libzstd and on the card;
  4. the zstd decode tiers (literals, sequences, mixed), each frame from
     encode_frame_device with and without its sidecar and with
     STENOS_SEQ_ANCHORS=0, decoded by decode_payload_device and host
     libzstd (K3, K4, K5, K7, X1);
  5. the frame grid, bytesoftype x kind x size x level, plus a
     custom_shift frame a bytesoftype: the card's frame equals the host
     path's, the card decompresses it, the host path decompresses it;
     each level-1 frame, and one of its data cut to whole superblocks,
     also through decompress_frame_batched(keep_device=True), which must
     decode it or give None exactly when the frame is not all full-size
     METHOD_BLOCK superblocks;
  6. 64 MiB of sorted int32 at levels 5 and 9 (superblocks of 512 KiB and
     2 MiB): both round trips, and the frame against the host path's.

The data comes from the test suite's generators, with wider elements
zero-extended (gen_elements). chip_smoke.py's phase_grid calls grid() on a
subset, and takes its generators from here.

Usage: python tools/validate_cuda.py [--quick] [--device cuda] [--out FILE]
Prints a line a section and FAILS: n; exits 1 on any failure.
"""

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import stenos_tpu_torch as stt  # noqa: E402
from stenos_tpu_torch import frame as fr  # noqa: E402
from stenos_tpu_torch.constants import METHOD_BLOCK  # noqa: E402
from stenos_tpu_torch.engine import (compress_frame_device,  # noqa: E402
                                     decompress_frame_batched,
                                     roundtrip_device)
from stenos_tpu_torch.entropy.device_decode import \
    decode_payload_device  # noqa: E402
from stenos_tpu_torch.entropy.zstd_frame import \
    encode_frame_device  # noqa: E402
from stenos_tpu_torch.host import zstd as zstd_host  # noqa: E402

KINDS = ("sorted", "random", "same", "rle", "smallrange")
GRID = {"bpps": (1, 2, 3, 4, 5, 8, 16, 24, 300), "kinds": KINDS,
        "sizes": (100, 70_001, 400_000), "levels": (0, 1, 2, 5, 9)}
QUICK = {"bpps": (2, 4), "kinds": ("sorted", "random"),
         "sizes": (200_000,), "levels": (1, 2)}
LOOP_BPPS = tuple(range(1, 17)) + (24, 300)
CUSTOM = ("sorted", 70_001, 2, 3)  # kind, size, level, custom_shift
SEED = 20260816
MIB = 1024 * 1024


def check_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("validate_cuda: CUDA is not available (pass "
                         "--device cpu to run the plain versions)")
    return dev


def gen_elements(rng, bpp, nelem, kind):
    """The test suite's data generators (tests/conftest.py), with elements
    wider than 8 bytes zero-extended past their eighth byte."""
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


def grid_data(bpp, kind, nbytes, seed=SEED):
    """The grid's data for one (bpp, kind, size): the same in every run
    and in every subset of the grid."""
    rng = np.random.default_rng([seed, bpp, KINDS.index(kind), nbytes])
    return gen_elements(rng, bpp, nbytes // bpp + 1, kind)[
        : (nbytes // bpp) * bpp]


def batched_expected(frame, bpp) -> bool:
    """Whether decompress_frame_batched must decode the frame: it is not
    empty, its superblock is a whole number of blocks, its size a whole
    number of superblocks, and every record is METHOD_BLOCK."""
    dsize, sb, pos = fr.get_info(frame, bpp)
    if dsize == 0 or sb % (256 * bpp) or dsize % sb:
        return False
    for _ in range(dsize // sb):
        if frame[pos] != METHOD_BLOCK:
            return False
        pos += 4 + int.from_bytes(frame[pos + 1 : pos + 4], "little")
    return True


def batched_check(dev, frame, data, bpp):
    """decompress_frame_batched(keep_device=True) of a frame: (the failed
    check's name or None, whether it decoded the frame)."""
    got = decompress_frame_batched(frame, bpp, device=dev, keep_device=True)
    if (got is not None) != batched_expected(frame, bpp):
        return "batched-none", got is not None
    if got is not None and not np.array_equal(torch.cat(got).cpu().numpy(),
                                              data):
        return "batched-bytes", True
    return None, got is not None


def grid_case(dev, data, bpp, level, custom_shift=None, batched=False):
    """One frame of the grid: (the failed checks' names, empty when all
    pass; with batched, [whether decompress_frame_batched(keep_device=True)
    decoded it], else []). batched also takes the data cut to whole
    superblocks, when it holds one, through the card, the host path and
    decompress_frame_batched."""
    kw = {} if custom_shift is None else {"custom_shift": custom_shift}
    mine = stt.compress(data, bpp, level, device=dev, **kw)
    bad = []
    if mine != fr.compress(data, bpp, level, engine=None, **kw):
        bad.append("bits")
    if not np.array_equal(stt.decompress(mine, bpp, device=dev), data):
        bad.append("card-decode")
    if not np.array_equal(fr.decompress(mine, bpp, engine=None), data):
        bad.append("host-decode")
    decoded = []
    if batched:
        frames = [(mine, data)]
        _, sb, _ = fr.get_info(mine, bpp)
        whole = len(data) // sb * sb
        if 0 < whole < len(data):
            cut = data[:whole]
            fw = stt.compress(cut, bpp, level, device=dev)
            if fw != fr.compress(cut, bpp, level, engine=None):
                bad.append("bits-whole")
            frames.append((fw, cut))
        for f, d in frames:
            b, ok = batched_check(dev, f, d, bpp)
            decoded.append(ok)
            if b:
                bad.append(b)
    return bad, decoded


def grid(dev, bpps, kinds, sizes, levels, custom=CUSTOM, log=print):
    """The frame grid over bpps x kinds x sizes x levels, and with custom
    (kind, size, level, shift) one custom_shift frame a bpp. Returns
    {cases, fails, batched (frames decoded / None), seconds, failed}."""
    t0 = time.perf_counter()
    res = {"cases": 0, "fails": 0, "batched": [0, 0], "failed": []}
    for bpp in bpps:
        cases = [(k, n, lvl, None) for k in kinds for n in sizes
                 for lvl in levels]
        if custom is not None:
            cases.append(custom)
        for kind, nbytes, level, shift in cases:
            data = grid_data(bpp, kind, nbytes)
            batched = level == 1 and shift is None
            try:
                bad, decoded = grid_case(dev, data, bpp, level, shift,
                                         batched)
            except Exception as e:  # noqa: BLE001
                bad, decoded = [f"raised {e!r}"], []
            res["cases"] += 1
            for d in decoded:
                res["batched"][not d] += 1
            if bad:
                res["fails"] += 1
                line = (f"FAIL bpp={bpp} {kind} n={nbytes} lvl={level}"
                        f"{'' if shift is None else f' shift={shift}'}: "
                        + ", ".join(bad))
                res["failed"].append(line)
                log(line)
        log(f"bpp={bpp}: {len(cases)} frames")
    res["seconds"] = time.perf_counter() - t0
    return res


def closed_loop(dev, bpps=LOOP_BPPS, log=print):
    """roundtrip_device at each bpp: the failed bpps."""
    failed = []
    for bpp in bpps:
        block = 256 * bpp
        sb = max(1, min(128, 131072 // block)) * block
        raw = gen_elements(np.random.default_rng([SEED, bpp]), bpp,
                           8 * sb // bpp, "sorted")
        x = torch.from_numpy(raw.reshape(8, sb).copy()).to(dev)
        try:
            out = roundtrip_device(x, bpp, 2)[0]
            ok = np.array_equal(out.reshape(-1).cpu().numpy(), raw)
        except Exception as e:  # noqa: BLE001
            log(f"  device roundtrip bpp={bpp} raised: {e!r}")
            ok = False
        if not ok:
            failed.append(bpp)
            log(f"FAIL device roundtrip bpp={bpp}")
    log(f"device closed loop: {len(bpps) - len(failed)}/{len(bpps)} bpp ok")
    return failed


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded(dev, log=print):
    """compress_device_sharded at a world of 1 (NCCL on a card, gloo on the
    CPU) on 4 superblocks of sorted int32: equal to the host frame and to
    compress_frame_device. Returns the failures (0 or 1)."""
    import torch.distributed as dist

    from stenos_tpu_torch.parallel import compress_device_sharded, make_mesh

    raw = gen_elements(np.random.default_rng([SEED, 0]), 4, 4 * 32768,
                       "sorted")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        x = torch.from_numpy(raw.reshape(4, 131072).copy()).to(dev)
        shard, total = compress_device_sharded(x, 4, 1, make_mesh())
        got = shard[: int(total)].cpu().numpy().tobytes()
    finally:
        dist.destroy_process_group()
    dframe, length = compress_frame_device(x, 4, 1)
    ok = (got == fr.compress(raw, 4, 1, engine=None)
          and got == dframe[: int(length)].cpu().numpy().tobytes()
          and np.array_equal(fr.decompress(got, 4, engine=None), raw))
    log(("" if ok else "FAIL ") + "compress_device_sharded at a world of 1 "
        "== the host frame == compress_frame_device")
    return int(not ok)


def entropy_interop(dev, log=print):
    """compress(entropy="device") at level 2, decoded by host libzstd and
    on the card. Returns the failures (0 or 1)."""
    rng = np.random.default_rng([SEED, 1])
    noisy = np.cumsum(rng.normal(0, 300, 500_000)).astype("<i4").view(
        np.uint8)
    f = stt.compress(noisy, 4, 2, device=dev, entropy="device")
    ok = (np.array_equal(fr.decompress(f, 4, engine=None), noisy)
          and np.array_equal(stt.decompress(f, 4, device=dev), noisy))
    log(("" if ok else "FAIL ") + "device entropy frame: host libzstd and "
        "the card decode it")
    return int(not ok)


def tier_inputs():
    """validate_tpu.py's three decode tiers: literals, sequences (64-byte
    records of a 400-record pool), and the two mixed."""
    rng = np.random.default_rng([SEED, 2])
    lit = rng.integers(0, 64, 2 * 131072 + 999).astype(np.uint8)
    pool = rng.integers(0, 40, (400, 64)).astype(np.uint8)
    seqd = pool[rng.integers(0, 400, (2 * 131072) // 64)].reshape(-1)
    mixd = np.concatenate([lit[:131072], seqd[:131072],
                           lit[131072 : 2 * 131072]])
    return {"literals": lit, "sequences": seqd, "mixed": mixd}


def decode_tiers(dev, log=print):
    """Each tier through encode_frame_device with its sidecar, without it,
    and with STENOS_SEQ_ANCHORS=0; decode_payload_device on dev and host
    libzstd give the data back. Returns the failures."""
    fails = 0
    for name, d in tier_inputs().items():
        for variant in ("sidecar", "no sidecar", "STENOS_SEQ_ANCHORS=0"):
            old = os.environ.get("STENOS_SEQ_ANCHORS")
            if variant == "STENOS_SEQ_ANCHORS=0":
                os.environ["STENOS_SEQ_ANCHORS"] = "0"
            try:
                f = encode_frame_device(d, dev, sidecar=variant != "no "
                                        "sidecar")
                out = decode_payload_device(f, len(d), dev)
                ok = (out is not None
                      and np.array_equal(out.cpu().numpy(), d)
                      and zstd_host.decompress(f, len(d)) == d.tobytes())
            except Exception as e:  # noqa: BLE001
                log(f"  decode tier {name} ({variant}) raised: {e!r}")
                ok = False
            finally:
                if old is None:
                    os.environ.pop("STENOS_SEQ_ANCHORS", None)
                else:
                    os.environ["STENOS_SEQ_ANCHORS"] = old
            fails += not ok
            log(f"{'' if ok else 'FAIL '}decode tier {name} ({variant})")
    return fails


def big(dev, levels=(5, 9), log=print):
    """64 MiB of sorted int32 at each level: the card's round trip, the
    host path's decode of the card's frame and the frame against the host
    path's. Returns (failures, {level: times and ratio})."""
    raw = sorted_int32(64 * MIB)
    fails, times = 0, {}
    for level in levels:
        t0 = time.perf_counter()
        f = stt.compress(raw, 4, level, device=dev)
        t1 = time.perf_counter()
        back = stt.decompress(f, 4, device=dev)
        t2 = time.perf_counter()
        bad = []
        if not np.array_equal(back, raw):
            bad.append("card-decode")
        if not np.array_equal(fr.decompress(f, 4, engine=None), raw):
            bad.append("host-decode")
        t3 = time.perf_counter()
        if f != fr.compress(raw, 4, level, engine=None):
            bad.append("bits")
        t4 = time.perf_counter()
        times[level] = {"card_compress_s": t1 - t0,
                        "card_decompress_s": t2 - t1,
                        "host_compress_s": t4 - t3,
                        "ratio": len(raw) / len(f)}
        fails += bool(bad)
        log(f"{'FAIL ' if bad else ''}64 MiB sorted int32 level {level}: "
            f"{', '.join(bad) or 'ok'}; "
            + ", ".join(f"{k} {v:.3f}" for k, v in times[level].items()))
    return fails, times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    t0 = time.perf_counter()
    rec = {"device": str(dev), "quick": args.quick}
    if dev.type == "cuda":
        rec["card"] = torch.cuda.get_device_name(0)
    loop = closed_loop(dev, (4,) if args.quick else LOOP_BPPS)
    fails = len(loop)
    fails += sharded(dev)
    fails += entropy_interop(dev)
    fails += decode_tiers(dev)
    g = grid(dev, **(QUICK if args.quick else GRID))
    fails += g["fails"]
    print(f"grid: {g['cases']} frames, {g['fails']} failed, "
          f"{g['seconds']:.1f} s; decompress_frame_batched decoded "
          f"{g['batched'][0]} level-1 frames and gave None for "
          f"{g['batched'][1]}")
    rec.update(loop_failed=loop, grid=g)
    if not args.quick:
        bf, rec["big"] = big(dev)
        fails += bf
    rec["fails"] = fails
    rec["seconds"] = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"{rec['seconds']:.1f} s")
    print("FAILS:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
