"""stenos_tpu_torch.decompress: frame bytes to a host uint8 array."""

import numpy as np

from harness.entry import DecodeEntry


class Decompress(DecodeEntry):
    def program(self):
        import stenos_tpu_torch as st

        return lambda k: st.decompress(self.frames[k], self.bpp,
                                       device=self.device)

    def call(self, k):
        with self.span("pb.decompress"):
            return {"k": k, "out": self.fn(k)}

    def _nbytes(self, h):
        return int(h["out"].nbytes)

    def check(self, kept, lengths):
        """Every decoded byte of the kept calls against the seed's data."""
        off = 0
        step = 64 << 20
        for h in kept:
            out, ref = np.asarray(h["out"]).reshape(-1), self.host[h["k"]]
            m = min(len(out), len(ref))
            for i in range(0, m, step):
                off += int(np.count_nonzero(out[i : min(i + step, m)]
                                            != ref[i : min(i + step, m)]))
            off += abs(len(out) - len(ref))
        return {"bytes_differing": off}

    def control(self, k):
        """The data with bit 0 of every element's low byte cleared: one bit
        fewer a value, a lossy decode."""
        ref = self.host[k].reshape(-1, self.bpp).copy()
        ref[:, 0] &= 0xFE
        return ref.reshape(-1)

    def corrupt(self, out, mode, rng):
        out = np.array(out)
        if mode == "unchanged":
            return np.zeros_like(out)
        if mode == "half":
            out[len(out) // 2 :] = 0
        else:
            out[int(rng.integers(len(out)))] ^= 1
        return out


ENTRY = Decompress
