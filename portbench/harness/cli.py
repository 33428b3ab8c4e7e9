"""One run of one cell, as run.py's command line asks for it.

Set-up (data and inputs from the seed, the warm-up of every shape the
cell's calls use) is timed from process start to the first timed call
(setup_s). Then a closed loop calls the cell's entry point for --seconds
seconds; each call is timed by CUDA events from its start to its end on
the device (a compress's frame length on the host). The window ends with
the call that completes past the deadline, so a rate is all the calls'
bytes over all the window's time. With --trace 1 the window runs under
torch.profiler and the program's own timing hooks, and the line carries the
cell's per-layer metrics instead. After the window the kept calls' outputs
are compared with the plain reference (reference/), every number compared
is printed beside its limit, and the last line of standard output is the
result.
"""

import argparse
import contextlib
import importlib
import json
import os
import re
import sys
import time
import traceback
import types

from harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "stenos_tpu")

# the program's launch counters (module, name), read around a traced window
COUNTERS = (
    ("stenos_tpu_torch.ops.encode_kernel", "launches"),
    ("stenos_tpu_torch.ops.encode_kernel", "launches_index"),
    ("stenos_tpu_torch.ops.decode_kernel", "launches"),
    ("stenos_tpu_torch.ops.decode_kernel", "launches_derive"),
    ("stenos_tpu_torch.entropy.huff_kernel", "launches_histogram"),
    ("stenos_tpu_torch.entropy.huff_kernel", "launches_encode"),
    ("stenos_tpu_torch.entropy.huff_decode_kernel", "launches"),
    ("stenos_tpu_torch.entropy.fse_kernel", "launches"),
    ("stenos_tpu_torch.entropy.seqdec_kernel", "launches"),
    ("stenos_tpu_torch.entropy.seq_exec", "launches"),
    ("stenos_tpu_torch.entropy.device_decode", "host_ladder"),
)


def forbidden_modules():
    """Top-level names of loaded modules that the run must not load,
    compared whole (stenos_tpu_torch is not stenos_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc and g++ builds already go to stenos_tpu_torch/build/)."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda")


def _args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _counters():
    out = {}
    for mod, name in COUNTERS:
        try:
            v = getattr(importlib.import_module(mod), name, None)
        except ImportError:
            v = None
        if isinstance(v, int):
            out[f"{mod.rsplit('.', 1)[1]}.{name}"] = v
    return out


class _Clock:
    """A call's time by CUDA events on the card (by the host clock on the
    CPU, for the tests): stop() records the end behind the call's work,
    waits for it, and returns the milliseconds."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.e0.record()
        else:
            self.t = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            return self.e0.elapsed_time(self.e1)
        return (time.perf_counter() - self.t) * 1e3


def _end_to_end(name, entry, w, setup_s):
    """The value of an end-to-end metric named in BENCHMARK.json."""
    import numpy as np

    if name == "setup_s":
        return setup_s
    m = re.fullmatch(r"(compress|decompress)_(gbps|p(\d+)_ms)", name)
    if not m or m.group(1) != entry.op:
        raise spec.SpecError(f"{name} is no metric of a {entry.op} cell")
    if m.group(2) == "gbps":
        return w.raw_bytes / w.window_s / 1e9
    return float(np.percentile(w.call_ms, int(m.group(3))))


def run_window(entry, seconds, span, clock, sampled):
    """The closed loop. Returns a namespace: calls, failed, raw_bytes,
    coded_bytes, window_s, call_ms, lengths ((input, coded bytes) a call)
    and kept (the sampled calls' and each input's last call's handles)."""
    w = types.SimpleNamespace(calls=0, failed=0, raw_bytes=0, coded_bytes=0,
                              call_ms=[], lengths=[], kept=[], error=None)
    last = {}
    start = time.perf_counter()
    deadline = start + seconds
    with span("pb.window"):
        while True:
            k = w.calls % entry.n_inputs
            h = None
            with span("pb.call"):
                clock.start()
                try:
                    h = entry.call(k)
                except Exception:  # a call that raises is a failed call
                    w.error = w.error or traceback.format_exc()
                ms = clock.stop()
                if h is not None:
                    try:
                        raw, coded = entry.finish(h)
                    except Exception:
                        w.error = w.error or traceback.format_exc()
                        h = None
            if h is None:
                w.failed += 1
            else:
                w.raw_bytes += raw
                w.coded_bytes += coded
                w.call_ms.append(ms)
                w.lengths.append((k, coded))
                if w.calls in sampled:
                    w.kept.append(h)
                last[k] = h
            w.calls += 1
            if time.perf_counter() >= deadline:
                break
    w.window_s = time.perf_counter() - start
    w.kept += [h for _, h in sorted(last.items())
               if not any(h is x for x in w.kept)]
    return w


def _device(cell, allow_cpu):
    """The device the run uses, or None (said on standard error) when the
    machine lacks the cell's CUDA cards."""
    import torch

    if allow_cpu:
        return torch.device("cpu")
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {seen}", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def _per_layer(cell, entry, w, summary, timing, counters, kind):
    """The cell's per-layer metrics that their readers find."""
    run = types.SimpleNamespace(
        op=entry.op, calls=w.calls, raw_bytes=w.raw_bytes,
        coded_bytes=w.coded_bytes, window_s=w.window_s, call_ms=w.call_ms,
        launch_s=getattr(entry, "launch_s", None),
        engine_timing=timing[0], zstd_timing=timing[1], counters=counters,
        trace=summary, device_kind=kind)
    out = {}
    for m in cell.per_layer:
        v = cell.readers[m["name"]](run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv, t0=None, allow_cpu=False, patch=None, root=spec.ROOT):
    """Run one cell once; returns the exit code. allow_cpu (the tests) runs
    on the CPU instead of failing without a card; patch(entry), when given,
    is called after set-up (a control or a planted fault); root is the
    checkout whose BENCHMARK.json and benchmark folder name the cell."""
    t0 = time.perf_counter() if t0 is None else t0
    args = _args(argv)
    set_cache_dirs(root)
    try:
        cell = spec.Cell(spec.load(root), args.workload, os.path.join(
            root, os.path.basename(spec.BENCH_DIR)))
    except spec.SpecError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    device = _device(cell, allow_cpu)
    if device is None:
        return 2
    cuda = device.type == "cuda"
    traced = bool(args.trace)

    def span(name):
        if traced:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    entry = cell.entry(cell.config, cell.traffic, args.seed, device,
                       cell.make, span)
    entry.setup()
    if patch is not None:
        patch(entry)
    check = cell.traffic.get("check", {})
    n_first = check.get("sample_from_first", 0)
    sampled = set(np.random.default_rng([args.seed, 1]).choice(
        n_first, size=min(check.get("sampled_calls", 0), n_first),
        replace=False).tolist())
    clock = _Clock(device)
    with contextlib.ExitStack() as stack:
        if traced:
            import stenos_tpu_torch.engine as eng
            import stenos_tpu_torch.entropy.device_decode as dd

            eng.timing, dd.timing = [], {}
            before = _counters()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(
                activities=acts))
        w = run_window(entry, args.seconds, span, clock, sampled)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    extra = {}
    if traced:
        from harness.trace import read_profile

        summary = read_profile(prof)
        timing = (eng.timing, dd.timing)
        eng.timing = dd.timing = None
        after = _counters()
        extra["counters"] = {k: after[k] - before.get(k, 0) for k in after
                             if after[k] != before.get(k, 0)}
        metrics = _per_layer(cell, entry, w, summary, timing,
                             extra["counters"], kind)
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            extra["breakdown"] = {"device_ops": summary["device_ops"],
                                  "idle_gaps": summary["idle_gaps"]}
    else:
        metrics = {m["name"]: {"value": float(_end_to_end(
            m["name"], entry, w, setup_s)), "unit": m["unit"]}
            for m in cell.end_to_end}
    t_check = time.perf_counter()
    got = entry.check(w.kept, w.lengths)
    t_check = time.perf_counter() - t_check
    limits = entry.CHECKS
    correct = (w.failed == 0 and w.calls > 0
               and all(got[n] <= limits[n] for n in limits))
    if w.error:
        print(f"portbench: the first failed call:\n{w.error}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"portbench: {cell.name} seed {args.seed}: {w.calls} calls in "
          f"{w.window_s:.3f} s, {w.failed} failed, set-up {setup_s:.3f} s, "
          f"{len(w.kept)} calls checked in {t_check:.3f} s", file=sys.stderr)
    if w.call_ms:
        q = np.percentile(w.call_ms, [0, 25, 50, 75, 95, 100])
        print("portbench: call ms min/q1/median/q3/p95/max "
              + " ".join(f"{v:.4f}" for v in q), file=sys.stderr)
    for n in limits:
        print(f"check {n} {got[n]} limit {limits[n]}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": w.calls,
              "failed": w.failed, "metrics": metrics, "device": dev}
    result.update(extra)
    result["check"] = {n: {"value": got[n], "limit": limits[n]}
                       for n in limits}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
