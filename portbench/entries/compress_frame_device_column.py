"""stenos_tpu_torch.engine.compress_frame_device on device-resident 1-D
columns of any length: whole superblocks, then a short one. A call ends
when its frame length is on the host; its call and planted faults are the
2-D entry's."""

import numpy as np
import torch

from entries.compress_frame_device import CompressFrameDevice
from reference.column_frame import column_frame


class CompressFrameDeviceColumn(CompressFrameDevice):
    def __init__(self, config, traffic, seed, device, make, span):
        """Column k holds call_bytes / bytesoftype - d_k elements, d_k drawn
        from the seed in the traffic's dropped_samples (both ends in): the
        columns are no whole number of superblocks, so Entry's check of
        call_bytes is not made."""
        self.bpp = int(config["bytesoftype"])
        self.level = int(config["level"])
        self.n_inputs = int(traffic["distinct_inputs"])
        self.call_bytes = int(traffic["call_bytes"])
        lo, hi = traffic["dropped_samples"]
        dropped = np.random.default_rng([seed, 3]).integers(
            lo, hi + 1, self.n_inputs)
        self.sizes = [self.bpp * (self.call_bytes // self.bpp - int(d))
                      for d in dropped]
        self.seed, self.device, self.make, self.span = seed, device, make, span
        self.fn = None

    def setup(self):
        from stenos_tpu_torch.engine import compress_frame_device

        self.inputs = [self.make(self.seed, k, n, self.device).to(self.device)
                       for k, n in enumerate(self.sizes)]
        self.fn = lambda k: compress_frame_device(self.inputs[k], self.bpp,
                                                  self.level)
        self.len_host = torch.empty((), dtype=torch.int64,
                                    pin_memory=self.device.type == "cuda")
        self.launch_s = []
        self.warm()
        self.launch_s.clear()

    def finish(self, h):
        h["n"] = int(self.len_host)
        return self.sizes[h["k"]], h["n"]

    def check(self, kept, lengths):
        """Each kept call's frame, byte for byte, and every call's length,
        against the reference's frame of its column."""
        ref = [column_frame(x, self.bpp, self.level) for x in self.inputs]
        off = 0
        for h in kept:
            f, r = h["frame"][: h["n"]], ref[h["k"]]
            m = min(len(f), len(r))
            off += int((f[:m] != r[:m]).sum()) + abs(len(f) - len(r))
        bad = sum(n != len(ref[k]) for k, n in lengths)
        return {"frame_bytes_differing": off, "frame_lengths_differing": bad}

    def control(self, k):
        """The reference at block level 0 (no RLE, the lighter analysis)
        instead of the level's block level 2: a valid frame, not the
        library's."""
        f = column_frame(self.inputs[k], self.bpp, self.level, block_level=0)
        return f, torch.tensor(len(f), dtype=torch.int64, device=f.device)


ENTRY = CompressFrameDeviceColumn
