#!/usr/bin/env python
"""Randomized differential fuzz of the PyTorch port.

The card is held against the port's own host path. Each iteration draws
what tools/fuzz_parity.py draws (a generator of six, bytesoftype 1-16,
level 0-9, a size up to --max-bytes, a tight dst_size) and checks:
  - stenos_tpu_torch.compress(..., device=D) equals the port's host path
    (frame.compress(..., engine=None)) byte for byte;
  - the frame decompresses through both routes (device=D, engine=None);
  - a tight dst_size raises the same StenosError code on both sides;
  - every 10th iteration: a zstd frame of the data (the port's libzstd
    binding, a random level) decodes through
    entropy.device_decode.decode_payload_device on D to the same bytes;
  - every 15th: a custom_shift frame, the same checks;
  - every 25th: engine.decompress_frame_batched(keep_device=True) gives
    the data, or None exactly when the frame is not all full-size
    METHOD_BLOCK superblocks.
--against stenos_tpu also holds the host frame (and the batched decode's
result) to the JAX package's (CPU only: it imports JAX).

Usage:
    python tools/fuzz_port.py [--device cuda] [--seconds 600 | --iterations N]
                              [--seed 0] [--one SEED] [--max-bytes 600000]
    python tools/fuzz_port.py --device cpu --against stenos_tpu ...

It prints a DONE line with the counts and the seconds, and exits 1 on any
failure.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fuzz_parity import gen  # noqa: E402  (the JAX lane's generators)
from validate_cuda import batched_expected  # noqa: E402

import stenos_tpu_torch as stt  # noqa: E402
from stenos_tpu_torch import frame as fr  # noqa: E402
from stenos_tpu_torch.engine import decompress_frame_batched  # noqa: E402
from stenos_tpu_torch.entropy.device_decode import \
    decode_payload_device  # noqa: E402
from stenos_tpu_torch.host import zstd as zstd_host  # noqa: E402

KINDS = ["random", "sorted", "same", "rle", "smallrange", "records"]
ENTROPY_EVERY, CUSTOM_EVERY, BATCHED_EVERY = 10, 15, 25


def check_device(device: str, against=None):
    """Refuses a CUDA device that is absent, and --against on the card."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("fuzz_port: CUDA is not available (pass "
                             "--device cpu to fuzz the plain versions)")
        if against:
            raise SystemExit("fuzz_port: --against stenos_tpu runs on the "
                             "CPU only (it imports JAX)")


def _outcome(fn):
    """(frame or array, None) or (None, StenosError code)."""
    try:
        return fn(), None
    except stt.StenosError as e:
        return None, e.code


def _frame_checks(fails, tag, data, bpp, level, device, ref, **kw):
    """The card's frame against the host path's (and ref's), both
    decompress routes; returns the card's frame or None."""
    raw = np.frombuffer(data, np.uint8)
    mine, err = _outcome(lambda: stt.compress(raw, bpp, level, device=device,
                                              **kw))
    host, herr = _outcome(lambda: fr.compress(raw, bpp, level, engine=None,
                                              **kw))
    if ref is not None:
        want, werr = _outcome(lambda: ref.frame.compress(
            raw, bpp, level, engine=None, **kw))
        if (host, herr) != (want, werr):
            fails.append(f"FAIL host-vs-stenos_tpu {tag}")
    if (mine, err) != (host, herr):
        fails.append(f"FAIL bits {tag}: card {err or len(mine)}, host "
                     f"{herr or len(host)}")
        return None
    if mine is None:
        return None
    for route in ({"device": device}, {"engine": None}):
        back, e = _outcome(lambda: stt.decompress(mine, bpp, **route))
        if back is None or back.tobytes() != data:
            fails.append(f"FAIL roundtrip {route} {tag}: {e}")
    return mine


def iteration(it_seed, device="cuda", against=None, max_bytes=600_000,
              entropy=False, custom=False, batched=False):
    """One iteration (see the module docstring): the failures found, as
    lines. against: None, or the stenos_tpu package."""
    rng = np.random.default_rng(it_seed)
    bpp = int(rng.integers(1, 17))
    level = int(rng.integers(0, 10))
    nbytes = int(rng.integers(0, max_bytes))
    nbytes -= nbytes % bpp
    kind = KINDS[int(rng.integers(0, len(KINDS)))]
    data = gen(rng, kind, bpp, nbytes)
    nbytes = len(data)
    tag = f"seed={it_seed}: {kind} bpp={bpp} lvl={level} n={nbytes}"
    fails = []
    try:
        mine = _frame_checks(fails, tag, data, bpp, level, device, against)
        if mine is not None and len(mine) > 16:
            tight = int(rng.integers(0, len(mine)))
            raw = np.frombuffer(data, np.uint8)
            card = _outcome(lambda: stt.compress(raw, bpp, level,
                                                 dst_size=tight,
                                                 device=device))
            host = _outcome(lambda: fr.compress(raw, bpp, level,
                                                dst_size=tight, engine=None))
            if card != host:
                fails.append(f"FAIL dst-behavior {tag} tight={tight}: card "
                             f"{card[1]}, host {host[1]}")
        if entropy and nbytes > 1024:
            zl = int(rng.integers(0, 10))
            c = zstd_host.compress(data, len(data) + 1024, zl)
            out = decode_payload_device(c, nbytes, device)
            if out is None or out.cpu().numpy().tobytes() != data:
                fails.append(f"FAIL entropy-tier {tag} stenos zl={zl}: "
                             f"{'host ladder' if out is None else 'bytes'}")
        if custom and 0 < nbytes <= 300_000:
            shift = int(rng.integers(0, 8))
            _frame_checks(fails, f"{tag} custom_shift={shift}", data, bpp,
                          level, device, against, custom_shift=shift)
        if batched and mine is not None:
            got = decompress_frame_batched(mine, bpp, device=device,
                                           keep_device=True)
            if (got is not None) != batched_expected(mine, bpp):
                fails.append(f"FAIL batched None-ness {tag}: "
                             f"{got is None}")
            elif got is not None and b"".join(
                    t.cpu().numpy().tobytes() for t in got) != data:
                fails.append(f"FAIL batched bytes {tag}")
            if against is not None:
                from stenos_tpu.engine_jax import \
                    decompress_frame_batched as ref_batched

                want = ref_batched(mine, bpp)
                if (want is None) != (got is None):
                    fails.append(f"FAIL batched vs stenos_tpu {tag}")
    except Exception as e:  # noqa: BLE001
        fails.append(f"FAIL exception {tag}: {e!r}")
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--against", choices=["stenos_tpu"],
                    help="also hold the host path to the JAX package's "
                         "(CPU only)")
    ap.add_argument("--seconds", type=float, default=600)
    ap.add_argument("--iterations", type=int,
                    help="stop after this many iterations (else --seconds)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", type=int, help="run one iteration with this "
                    "seed, every periodic check on")
    ap.add_argument("--max-bytes", type=int, default=600_000)
    args = ap.parse_args(argv)
    check_device(args.device, args.against)
    against = None
    if args.against:
        import stenos_tpu as against  # noqa: F811

    master = np.random.default_rng(args.seed)
    t0 = time.time()
    t_end = t0 + args.seconds
    iters = nfail = 0
    while True:
        if args.one is not None:
            if iters:
                break
        elif (iters >= args.iterations if args.iterations is not None
              else time.time() >= t_end):
            break
        iters += 1
        one = args.one is not None
        seed = args.one if one else int(master.integers(0, 2**63))
        lines = iteration(seed, args.device, against, args.max_bytes,
                          entropy=one or iters % ENTROPY_EVERY == 0,
                          custom=one or iters % CUSTOM_EVERY == 0,
                          batched=one or iters % BATCHED_EVERY == 0)
        for line in lines:
            print(f"iter {iters} {line}", flush=True)
        nfail += bool(lines)
        if iters % 25 == 0:
            print(f"... {iters} iters, {nfail} fails", flush=True)
    print(f"DONE: {iters} iterations, {nfail} failures "
          f"({time.time() - t0:.1f} s)")
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())
