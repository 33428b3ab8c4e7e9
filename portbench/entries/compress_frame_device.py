"""stenos_tpu_torch.engine.compress_frame_device on device-resident
(n_sb, sb) tensors; a call ends when its frame length is on the host."""

import time

import torch

from harness.entry import Entry
from reference.block_frame import block_frame


class CompressFrameDevice(Entry):
    op = "compress"
    CHECKS = {"frame_bytes_differing": 0, "frame_lengths_differing": 0}

    def setup(self):
        from stenos_tpu_torch.engine import compress_frame_device

        self.inputs = [self.make(self.seed, k, self.call_bytes, self.device)
                       .to(self.device).view(-1, self.sb)
                       for k in range(self.n_inputs)]
        self.fn = lambda k: compress_frame_device(self.inputs[k], self.bpp,
                                                  self.level)
        self.len_host = torch.empty((), dtype=torch.int64,
                                    pin_memory=self.device.type == "cuda")
        self.launch_s = []
        self.warm()
        self.launch_s.clear()

    def call(self, k):
        t = time.perf_counter()
        with self.span("pb.launch"):
            frame, length = self.fn(k)
        self.launch_s.append(time.perf_counter() - t)
        with self.span("pb.read_length"):
            self.len_host.copy_(length, non_blocking=True)
        return {"k": k, "frame": frame}

    def finish(self, h):
        h["n"] = int(self.len_host)
        return self.call_bytes, h["n"]

    def check(self, kept, lengths):
        """Each kept call's frame, byte for byte, and every call's length,
        against the reference's frame of its input."""
        ref = [block_frame(x, self.bpp, self.level) for x in self.inputs]
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
        f = block_frame(self.inputs[k], self.bpp, self.level, block_level=0)
        return f, torch.tensor(len(f), dtype=torch.int64, device=f.device)

    def corrupt(self, out, mode, rng):
        frame, length = out
        n = int(length)
        if mode == "unchanged":
            return torch.zeros_like(frame), length
        frame = frame.clone()
        if mode == "half":
            frame[n // 2 : n] = 0
        else:
            frame[int(rng.integers(n))] ^= 1
        return frame, length


ENTRY = CompressFrameDevice
