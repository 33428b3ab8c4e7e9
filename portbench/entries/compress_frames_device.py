"""stenos_tpu_torch.engine.compress_frames_device on batches of
device-resident images, a frame each: a call compresses frames_per_call
images of call_bytes bytes in one launch and ends when their lengths are
on the host (one copy into pinned memory)."""

import torch

from harness.entry import Entry
from reference.frame_batch import frame_batch


class CompressFramesDevice(Entry):
    op = "compress"
    CHECKS = {"frame_bytes_differing": 0, "frame_lengths_differing": 0}

    def __init__(self, config, traffic, seed, device, make, span):
        super().__init__(config, traffic, seed, device, make, span)
        self.per_call = int(traffic["frames_per_call"])

    def setup(self):
        # first, so that a program without the entry point fails at once
        from stenos_tpu_torch.engine import compress_frames_device

        f = self.per_call
        self.inputs = [torch.stack([
            self.make(self.seed, k * f + i, self.call_bytes, self.device)
            .to(self.device) for i in range(f)])
            for k in range(self.n_inputs)]
        self.fn = lambda k: compress_frames_device(self.inputs[k], self.bpp,
                                                   self.level)
        self.len_host = torch.empty(f, dtype=torch.int64,
                                    pin_memory=self.device.type == "cuda")
        self.seen = []  # (input, its frames' lengths) of each finished call
        self.warm()
        self.seen.clear()

    def call(self, k):
        with self.span("pb.launch"):
            out, lengths = self.fn(k)
        with self.span("pb.read_length"):
            self.len_host.copy_(lengths, non_blocking=True)
        return {"k": k, "out": out}

    def finish(self, h):
        n = self.len_host.tolist()
        h["n"] = n
        self.seen.append((h["k"], n))
        return self.per_call * self.call_bytes, sum(n)

    def check(self, kept, lengths):
        """Each kept call's rows, byte for byte over the whole row (its
        frame, then zeros), and each frame's length of every call of the
        window, against the reference's batch of its input."""
        ref = [frame_batch(x, self.bpp, self.level) for x in self.inputs]
        want = [r[1].tolist() for r in ref]
        off = 0
        for h in kept:
            got, r = h["out"], ref[h["k"]][0]
            if got.shape != r.shape:
                off += max(got.numel(), r.numel())
                continue
            off += int((got != r).sum())
        bad = sum(a != b for k, n in self.seen for a, b in zip(n, want[k]))
        bad += sum(len(n) != len(want[k]) for k, n in self.seen)
        return {"frame_bytes_differing": off, "frame_lengths_differing": bad}

    def control(self, k):
        """The reference at block level 0 (no RLE, the lighter analysis)
        instead of the level's block level 2: valid frames, not the
        library's."""
        return frame_batch(self.inputs[k], self.bpp, self.level,
                           block_level=0)

    def corrupt(self, out, mode, rng):
        rows, lengths = out
        if mode == "unchanged":
            return torch.zeros_like(rows), lengths
        n = lengths.tolist()
        rows = rows.clone()
        if mode == "half":
            for f, m in enumerate(n):
                rows[f, m // 2 : m] = 0
        else:
            f = int(rng.integers(len(n)))
            rows[f, int(rng.integers(n[f]))] ^= 1
        return rows, lengths


ENTRY = CompressFramesDevice
