"""The traced window: torch.profiler over the calls, reduced to what the
per-layer metrics and the breakdown read.

The harness marks its own spans with record_function ("pb.window" around
the whole window, "pb.call" around each call, and the entries' spans inside
it); the profiler's Chrome trace puts them and the device's operations on
one clock. The trace is written to a temporary file under TMPDIR, read and
deleted.
"""

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def short_name(name: str) -> str:
    """A device operation's name without its return type, template
    arguments and parameters (a memcpy's or memset's whole)."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:96]
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name.split("<")[0].split("(")[0].strip()[:96] or name[:96]


def _union(intervals):
    """Merged [start, end] of intervals sorted by start."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events):
    """Reduce Chrome trace events (times in microseconds) to a dict:
    window_s (the pb.window span), busy_s (the union of device operations
    inside it), kernel_s (the summed time of every kernel inside it),
    device_ops (the TOP device operations by summed time, [name, s]) and
    idle_gaps (the TOP longest stretches of the window in which no device
    operation ran, each named by the innermost pb.* span of the host that
    covers its middle, [name, s]). None when the window span is missing."""
    win = [e for e in events
           if e.get("ph") == "X" and e.get("name") == "pb.window"
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernel_us, by_name = [], 0.0, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if t <= s:
            continue
        dev.append((s, t))
        if e["cat"] == "kernel":
            kernel_us += t - s
        n = short_name(e.get("name", "?"))
        by_name[n] = by_name.get(n, 0.0) + t - s
    busy = _union(dev)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("pb.")
             and e["name"] != "pb.window"]

    def doing(mid):
        cover = [(t - s, n) for s, t, n in spans if s <= mid <= t]
        return min(cover)[1] if cover else "pb.window"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_ops": [[n, v / 1e6] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[doing((s + t) / 2), (t - s) / 1e6]
                      for s, t in gaps[:TOP]],
    }


def read_profile(prof):
    """summarize() of a finished torch.profiler.profile."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return summarize(doc.get("traceEvents", doc)
                     if isinstance(doc, dict) else doc)
