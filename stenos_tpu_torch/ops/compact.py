"""Order-preserving compaction of ragged sections, in plain torch ops.

The block stream is a ragged concatenation of variable-size sections laid
out at padded slots with a validity mask; compaction moves the valid lanes of
each row to its front, in order. Here that is an inclusive count of valid
lanes and one scatter. The JAX package's log-shift network
(stenos_tpu/ops/compact.py) gives the same output; it exists only because
element scatters are slow on a TPU.
"""

import torch


def compact(values, valid):
    """Compact the valid lanes of (n, W) rows to the front (order kept).

    Returns (compacted (n, W) int32, counts (n,) int32): lanes past counts are
    zero."""
    n, width = values.shape
    pos = torch.cumsum(valid.to(torch.int32), -1)
    counts = pos[:, -1].to(torch.int32)
    # invalid lanes aim at a spill column that is dropped afterwards
    dest = torch.where(valid, pos - 1, width).long()
    out = torch.zeros((n, width + 1), dtype=torch.int32, device=values.device)
    out.scatter_(1, dest, values.to(torch.int32) & 255)
    return out[:, :width], counts
