"""Data of the sorted-i32 configuration: sorted uint32 keys below 2**30.

The semantics of tools/validate_cuda.py's sorted_int32 (bench.py's headline
data), made on the card instead: one torch.Generator on the data's device,
seeded from (seed, index), draws the keys and the card sorts them, so a
512 MiB array takes a fraction of a second of set-up instead of the host's
seconds for np.sort.
"""

import numpy as np
import torch


def make(seed: int, index: int, nbytes: int, device) -> torch.Tensor:
    """The index-th array of a run with this seed: nbytes (a multiple of 4)
    of little-endian sorted uint32 keys below 2**30, as a 1-D uint8 tensor
    on device. The same (seed, index, nbytes) gives the same bytes."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) & (2**63 - 1))
    keys = torch.randint(0, 1 << 30, (nbytes // 4,), generator=g,
                         device=device, dtype=torch.int32)
    return torch.sort(keys).values.view(torch.uint8)
