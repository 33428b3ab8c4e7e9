"""Nanosecond monotonic timer: stenos_timer parity (stenos.h:258-288,
timer.hpp:49-132), and profile_trace, a torch.profiler trace of a region
with the program's spans in it. Ported from stenos_tpu/utils/timer.py,
whose profile_trace takes a jax.profiler trace."""

import contextlib
import time


class Timer:
    """tick()/tock() nanosecond timer (monotonic)."""

    def __init__(self):
        self._t0 = time.perf_counter_ns()

    def tick(self) -> None:
        self._t0 = time.perf_counter_ns()

    def tock(self) -> int:
        return time.perf_counter_ns() - self._t0


@contextlib.contextmanager
def profile_trace(path: str):
    """Run the region under torch.profiler (the CPU, and CUDA where there is
    a card) with the span recorder on (utils/trace.py: engine.timing is set
    to a list for the region when it was None), and write the trace to
    path as a Chrome trace (chrome://tracing, Perfetto): the program's
    "stn.*" spans on the timeline of the kernels they launch. Yields the
    profiler."""
    import torch

    from .. import engine

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    switched = engine.timing is None
    if switched:
        engine.timing = []
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        if switched:
            engine.timing = None
    prof.export_chrome_trace(path)
