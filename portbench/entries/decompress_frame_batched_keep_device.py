"""stenos_tpu_torch.engine.decompress_frame_batched(keep_device=True):
frame bytes to uint8 tensors on the card, one a 64 MiB batch; a call ends
when its last batch has decoded."""

import torch

from harness.entry import DecodeEntry


class DecompressKeepDevice(DecodeEntry):
    def program(self):
        from stenos_tpu_torch.engine import decompress_frame_batched

        return lambda k: decompress_frame_batched(
            self.frames[k], self.bpp, keep_device=True, device=self.device)

    def call(self, k):
        with self.span("pb.restore"):
            outs = self.fn(k)
        if outs is None:
            raise RuntimeError("decompress_frame_batched returned None")
        return {"k": k, "outs": outs}

    def _nbytes(self, h):
        return sum(int(o.numel()) for o in h["outs"])

    def check(self, kept, lengths):
        """Every decoded byte of the kept calls, the batches in order,
        against the seed's data."""
        off = 0
        for h in kept:
            out = torch.cat([o.reshape(-1) for o in h["outs"]])
            ref = self.data[h["k"]].to(out.device)
            m = min(len(out), len(ref))
            off += int((out[:m] != ref[:m]).sum()) + abs(len(out) - len(ref))
        return {"bytes_differing": off}

    def control(self, k):
        """The data with bit 0 of every element's low byte cleared: one bit
        fewer a value, a lossy decode."""
        ref = self.data[k].to(self.device).view(-1, self.bpp).clone()
        ref[:, 0] &= 0xFE
        return list(ref.view(-1).split(64 << 20))

    def corrupt(self, outs, mode, rng):
        outs = [o.clone() for o in outs]
        if mode == "unchanged":
            return [torch.zeros_like(o) for o in outs]
        if mode == "half":
            cut = sum(o.numel() for o in outs) // 2
            for o in outs:
                o[max(0, cut) :] = 0
                cut -= o.numel()
        else:
            o = outs[int(rng.integers(len(outs)))]
            o[int(rng.integers(o.numel()))] ^= 1
        return outs


ENTRY = DecompressKeepDevice
