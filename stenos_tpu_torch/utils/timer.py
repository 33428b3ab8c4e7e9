"""Nanosecond monotonic timer: stenos_timer parity (stenos.h:258-288,
timer.hpp:49-132). Ported from stenos_tpu/utils/timer.py; its jax.profiler
trace helper is not ported (CUDA events time the kernels, chip_smoke.py)."""

import time


class Timer:
    """tick()/tock() nanosecond timer (monotonic)."""

    def __init__(self):
        self._t0 = time.perf_counter_ns()

    def tick(self) -> None:
        self._t0 = time.perf_counter_ns()

    def tock(self) -> int:
        return time.perf_counter_ns() - self._t0
