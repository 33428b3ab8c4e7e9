"""What every entry point shares. An entry point of stenos_tpu_torch that a
traffic file can name ("entry") is entries/<name>.py, whose ENTRY is a
subclass of Entry: its set-up, one call, the check of its outputs against
the plain reference, and its control and planted faults.

An entry's `fn(k)` is the program's call on input k: the window times it,
and a control or a planted fault replaces it (harness/controls.py).
`call(k)` runs it and starts whatever the call still owes the host (a
length's copy); `finish(h)`, after the device is synchronized, gives
(uncompressed bytes, coded bytes) of the call; `check(kept, lengths)`
compares the kept calls' outputs with the reference and returns each
number compared. CHECKS gives each number's limit: the comparisons are
exact. `control(k)` is the reference put in the program's place one step
below what the configuration states; `corrupt(out, mode, rng)` plants a
fault in a call's output.
"""

import torch


class Entry:
    op = None
    CHECKS = {}

    def __init__(self, config, traffic, seed, device, make, span):
        self.bpp = int(config["bytesoftype"])
        self.level = int(config["level"])
        self.sb = int(config["superblock_bytes"])
        self.n_inputs = int(traffic["distinct_inputs"])
        self.call_bytes = int(traffic["call_bytes"])
        if self.call_bytes % self.sb:
            raise ValueError("call_bytes is no whole number of superblocks")
        self.seed, self.device, self.make, self.span = seed, device, make, span
        self.fn = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        """Every input through the call twice: builds, pinned buffers and
        the allocator's blocks are in place before the window."""
        for _ in range(2):
            for k in range(self.n_inputs):
                h = self.call(k)
                self.sync()
                self.finish(h)




class DecodeEntry(Entry):
    """A decode entry: frames made in set-up by stenos_tpu_torch.compress
    (one thread, the card's engine) from the seed's data, which is kept as
    the reference (data: as made; host: a numpy copy)."""

    op = "decompress"
    CHECKS = {"bytes_differing": 0}

    def setup(self):
        import stenos_tpu_torch as st

        self.data = [self.make(self.seed, k, self.call_bytes, self.device)
                     for k in range(self.n_inputs)]
        self.host = [d.cpu().numpy() for d in self.data]
        self.frames = [st.compress(a, self.bpp, self.level,
                                   device=self.device) for a in self.host]
        self.fn = self.program()
        self.warm()

    def finish(self, h):
        return self._nbytes(h), len(self.frames[h["k"]])
