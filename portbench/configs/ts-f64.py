"""Data of the ts-f64 configuration: one channel of float64 samples at 1 kHz.

The statistics of benchs/datasets.py's ts_f64 (the stenos_dataset double
time series family), with its periods on a 1 kHz clock: 100 + a random walk
of N(0, 1e-3) steps + 0.5 sin(2 pi t / day) + 0.05 sin(2 pi t / hour) + 0.8
a regime jump, each sample jumping with probability 1e-5. Made on the card:
one torch.Generator on the data's device, seeded from (seed, index), draws
the steps and the jumps. The steps are rounded to ticks of 1e-6 and summed
as int64, so the walk is exact and the same on every run; every other step
is elementwise.
"""

import math

import numpy as np
import torch

DAY = 86_400_000  # samples of a day at 1 kHz
HOUR = 3_600_000


def make(seed: int, index: int, nbytes: int, device) -> torch.Tensor:
    """The index-th column of a run with this seed: nbytes (a multiple of
    8) of little-endian float64 samples from the start of a day, as a 1-D
    uint8 tensor on device. The same (seed, index, nbytes) gives the same
    bytes."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) & (2**63 - 1))
    n = nbytes // 8
    f64 = torch.float64
    ticks = torch.randn(n, generator=g, device=device, dtype=f64)
    ticks = ticks.mul_(1000).round_().to(torch.int64).cumsum_(0)
    jumps = (torch.rand(n, generator=g, device=device) < 1e-5).cumsum(0)
    t = torch.arange(n, device=device, dtype=f64)
    v = (t * (2 * math.pi / DAY)).sin_().mul_(0.5)
    v += (t * (2 * math.pi / HOUR)).sin_().mul_(0.05)
    del t
    v += ticks.to(f64).mul_(1e-6)
    v += jumps.to(f64).mul_(0.8)
    return v.add_(100.0).view(torch.uint8)
