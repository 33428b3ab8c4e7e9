"""Spans at the port's layer boundaries, on its two timing switches.

The recorder is on while `engine.timing` or `entropy.device_decode.timing`
is set (not None): those module attributes are the port's switches, and
assigning either turns the recorder on or off (switch() makes it so).
Turning it on from off starts a new recording, which drops the spans of
the one before. Off, span() returns a shared null context: it records
nothing, makes no CUDA event and opens no profiler range.

    with trace.span("stn.k1.launch", device=dev, nbytes=n) as s:
        launch(...)

A span records its name, its parent (the innermost open span of its
thread, or `parent=` for work handed to another thread), its call (the id
of its outermost span, shared by every span of one call), its host start
and end (time.perf_counter_ns), and the bytes, superblocks and frames it
handled.
Given a CUDA device, it also records a pair of timing events on the
device's current stream around the work it enqueues; nothing waits for
them in the call: they are resolved when read (device_ms(), report()),
after the caller has synchronized. While a torch.profiler runs, each span
also opens torch.profiler.record_function(name), so that the profiler's
trace shows the program's spans (names "stn.*") on the timeline of the
kernels they launch; utils/timer.profile_trace turns the recorder on
around such a trace.

On an H100's host a span costs ~0.5 us off; on, ~3 us of its own, ~11
us more for the profiler's range and ~12 us for each of its two events.
"""

import itertools
import threading
import time
import types

import torch

_on = False
_records = []  # this recording's finished spans
_switches = []  # the modules whose `timing` is a switch
_local = threading.local()
_ids = itertools.count(1)
_streams = {}  # (device index, raw stream): the torch Stream


class _Null:
    """The span while the recorder is off."""

    __slots__ = ()
    host_ms = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "id", "parent", "call", "thread", "t0", "t1",
                 "nbytes", "superblocks", "frames", "events", "_device",
                 "_queue", "_range", "_into")

    def __init__(self, name, device, parent, nbytes, superblocks, frames):
        self.name, self.parent = name, parent
        self.nbytes, self.superblocks = nbytes, superblocks
        self.frames = frames
        self._device = device
        self.events = None

    def __enter__(self):
        stack = _stack()
        up = self.parent if isinstance(self.parent, _Span) else (
            stack[-1] if stack else None)
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.call = up.call if up else self.id
        self.thread = threading.get_ident()
        self._into = _records
        self.t0 = time.perf_counter_ns()
        self._range = None
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        dev = self._device
        if dev is not None and dev.type == "cuda":
            self._queue = _stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self._queue)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self.events is not None:
            self.events[1].record(self._queue)
        if self._range is not None:
            self._range.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        self._into.append(self)
        return False

    @property
    def host_ms(self):
        return (self.t1 - self.t0) / 1e6

    def device_ms(self):
        """Milliseconds between the span's two events on the card (it waits
        for the second), or None for a span with no events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


def _stream(dev):
    """The current stream of a CUDA device (torch.cuda.current_stream
    takes ~9 us; the raw handle's lookup well under one)."""
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.current_stream(idx)
    return s


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name, device=None, parent=None, nbytes=0, superblocks=0,
         frames=0):
    """A context manager for one span (see the module docstring); the
    shared null context while the recorder is off."""
    if not _on:
        return _NULL
    return _Span(name, device, parent, nbytes, superblocks, frames)


def current():
    """The innermost open span of this thread (None when there is none):
    the parent to hand to work that another thread runs."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def records():
    """The recording's finished spans, in the order they started: each has
    name, id, parent (an id, None for an outermost span), call, thread,
    t0 and t1 (ns), nbytes, superblocks, frames, host_ms and device_ms()."""
    return sorted(_records, key=lambda s: s.t0)


def _switched():
    global _on, _records
    now = any(m.timing is not None for m in _switches)
    if now and not _on:
        _records = []
    _on = now


class _Switch(types.ModuleType):
    """A module whose `timing` attribute is a switch of the recorder."""

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name == "timing":
            _switched()


def switch(module):
    """Make assignments to module.timing turn the recorder on and off."""
    module.__class__ = _Switch
    _switches.append(module)
    _switched()


def report():
    """The recording's spans by name: {"spans": {name: {"calls", "host_ms"
    (total), "self_ms" (total, less the host time of child spans on the
    same thread), "max_ms", "device_ms" (total of the event pairs; None
    for a name with none), "bytes", "superblocks", "frames"}}, "gaps_ms":
    {name: [ms]}}. gaps_ms gives, for each name of outermost spans whose
    calls launched work with events, the card's time from the last event of
    one such call to the first event of the next, in order: how long the
    card waited between the calls. Waits for the events it reads."""
    recs = records()
    byid = {s.id: s for s in recs}
    child_ns = {}
    for s in recs:
        up = byid.get(s.parent)
        if up is not None and up.thread == s.thread:
            child_ns[up.id] = child_ns.get(up.id, 0) + s.t1 - s.t0
    spans = {}
    for s in recs:
        r = spans.setdefault(s.name, {
            "calls": 0, "host_ms": 0.0, "self_ms": 0.0, "max_ms": 0.0,
            "device_ms": None, "bytes": 0, "superblocks": 0, "frames": 0})
        r["calls"] += 1
        r["host_ms"] += s.host_ms
        r["self_ms"] += (s.t1 - s.t0 - child_ns.get(s.id, 0)) / 1e6
        r["max_ms"] = max(r["max_ms"], s.host_ms)
        d = s.device_ms()
        if d is not None:
            r["device_ms"] = (r["device_ms"] or 0.0) + d
        r["bytes"] += s.nbytes
        r["superblocks"] += s.superblocks
        r["frames"] += s.frames
    first, last = {}, {}  # call id: its first start event, its last end
    for s in recs:
        if s.events is not None:
            first.setdefault(s.call, s.events[0])
            last[s.call] = s.events[1]
    gaps, prev = {}, {}
    for s in recs:
        if s.parent is None and s.id in first:
            if s.name in prev:
                gaps.setdefault(s.name, []).append(
                    prev[s.name].elapsed_time(first[s.id]))
            prev[s.name] = last[s.id]
    return {"spans": spans, "gaps_ms": gaps}
