"""Data of the image-u16 configuration: a scientific camera's 16-bit frames.

The statistics of benchs/datasets.py's image_u16 (the stenos_dataset uint16
image family): a coarse N(0, 1) grid upsampled 16 times, smoothed by a
17-tap box filter along each axis, scaled to 200-3200 (a 12-bit range),
plus Poisson(8) shot noise. An image is WIDTH pixels wide, the rows of a
2048 x 2048 sensor, and as many rows as its bytes hold.

Made on the card in exact integer arithmetic, so that the same seed gives
the same bytes on every run: one torch.Generator on the data's device,
seeded from (seed, index), draws the grid (rounded to 1/4096) and the
uniforms of the shot noise; the box filters are sums by int64 cumsum, the
scaling an integer division, and the shot noise the inverse of Poisson(8)'s
distribution function (a table made on the host) at the uniforms.
"""

import math

import numpy as np
import torch

WIDTH = 2048  # pixels a row
UP = 16  # the grid's upsampling
TAPS = 17  # the box filter's taps
LOW, SPAN = 200, 3000  # the field's range: 200-3200
SHOT = 8  # the shot noise's mean
SHOT_MAX = 64  # draws stop here (P(X >= 64) < 1e-30)


def _box(x, dim):
    """The sum of TAPS neighbours along dim, zeros past the edges, as
    numpy's convolve(..., mode="same") of an odd box."""
    n, h = x.shape[dim], TAPS // 2
    shape = list(x.shape)
    shape[dim] = h + 1
    left = x.new_zeros(shape)
    shape[dim] = h
    c = torch.cat([left, x, x.new_zeros(shape)], dim).cumsum(dim)
    return c.narrow(dim, TAPS, n) - c.narrow(dim, 0, n)


def _shot_cdf(device) -> torch.Tensor:
    """Poisson(SHOT)'s distribution function at 0 .. SHOT_MAX - 1, its
    last entry 1."""
    p = [math.exp(-SHOT) * SHOT**k / math.factorial(k)
         for k in range(SHOT_MAX)]
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    return torch.tensor(cdf, dtype=torch.float64, device=device)


def make(seed: int, index: int, nbytes: int, device) -> torch.Tensor:
    """The index-th image of a run with this seed: nbytes (a multiple of 2)
    of little-endian uint16 pixels, row by row, as a 1-D uint8 tensor on
    device. The same (seed, index, nbytes) gives the same bytes."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) & (2**63 - 1))
    pixels = nbytes // 2
    w = min(WIDTH, pixels)
    h = -(-pixels // w)
    grid = torch.randn((h // UP + 2, w // UP + 2), generator=g,
                       device=device, dtype=torch.float64)
    grid = grid.mul_(4096).round_().to(torch.int64)
    up = grid.repeat_interleave(UP, 0).repeat_interleave(UP, 1)[:h, :w]
    up = _box(_box(up, 0), 1)
    lo, hi = up.min(), up.max()
    img = (up - lo).mul_(SPAN).div_((hi - lo).clamp_(min=1),
                                    rounding_mode="floor").add_(LOW)
    u = torch.rand((h, w), generator=g, device=device, dtype=torch.float64)
    img += torch.searchsorted(_shot_cdf(device), u)
    return img.flatten()[:pixels].to(torch.int16).view(torch.uint8)
