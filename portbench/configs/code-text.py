"""Data of the code-text configuration: source text, repeated.

The pattern of benchs/datasets.py's text_u8 (the frozen excerpt repeated to
the size asked for), rewritten to start at an offset drawn from the seed.
The excerpt is data/code_text.txt, a copy of benchs/data/code_text.txt.
"""

import os

import numpy as np
import torch

_TEXT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "code_text.txt")


def make(seed: int, index: int, nbytes: int, device) -> torch.Tensor:
    """The index-th array of a run with this seed: nbytes of the excerpt
    repeated from a seed-chosen offset, as a 1-D uint8 tensor on the host
    (the zstd stage's frames are made and read there). The same (seed,
    index, nbytes) gives the same bytes."""
    base = np.fromfile(_TEXT, np.uint8)
    off = int(np.random.default_rng([seed, index]).integers(len(base)))
    out = np.empty(nbytes, np.uint8)
    period = np.roll(base, -off)
    reps = nbytes // len(base)
    out[: reps * len(base)].reshape(reps, len(base))[:] = period
    out[reps * len(base):] = period[: nbytes - reps * len(base)]
    return torch.from_numpy(out)
