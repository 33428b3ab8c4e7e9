"""The host side of the port's batched decodes: the one host-thread budget,
the pinned staging buffers, the threads that run a batch's host pass and
its copy into the output, and that copy.

frame.py's batchers (_BlockChunk, _ZstdChunk), engine.prepare_blocks,
entropy/device_decode.prepare and the mesh decode (parallel/api.py) draw on
it. It imports nothing from the rest of the package.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# threads of the native host passes (the row parse, the libzstd unpack, the
# zstd host pass; the GIL released) and of the copy into the output
HOST_THREADS = min(8, os.cpu_count() or 1)

# a batch's host pass, while the batch before it decodes; a batch's copy
# into the output, while the next one decodes; that copy's slices. Their
# threads start on first use
host_pass = ThreadPoolExecutor(1)
out_copy = ThreadPoolExecutor(1)
_copy = ThreadPoolExecutor(HOST_THREADS)


class Staging:
    """The host staging buffers of one caller (a decompress, or one batch):
    pinned for a CUDA device, reused from chunk to chunk, grown on demand.
    Callers do not share one: a buffer is rewritten by the next chunk.
    uploaded: the CUDA event recorded behind the last upload from these
    buffers (TorchEngine.decode_blocks); a caller refills them only after
    it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bufs = {}
        self.uploaded = None

    def get(self, name, nbytes):
        """A (nbytes,) uint8 host tensor, the one kept under name."""
        if self.device.type != "cuda":
            return torch.empty(nbytes, dtype=torch.uint8)
        b = self.bufs.get(name)
        if b is None or b.numel() < nbytes:
            b = self.bufs[name] = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)
        return b[:nbytes]


def runs(pieces):
    """A batch's copy-out runs [w, o, n]: pieces are (w, o, n), in order,
    the n bytes at o of the batch's buffer that go to out[w:]; pieces that
    follow each other in both merge into one run."""
    out = []
    for w, o, n in pieces:
        if out and out[-1][0] + out[-1][2] == w and \
                out[-1][1] + out[-1][2] == o:
            out[-1][2] += n
        else:
            out.append([w, o, n])
    return out


def put(out, run, host):
    """out[w : w + n] = host[o : o + n] for run [w, o, n], in slices on
    HOST_THREADS threads: the first writes of a fresh output (its page
    faults) are most of the copy's time."""
    w, o, n = run
    piece = -(-n // HOST_THREADS)
    list(_copy.map(
        lambda a: np.copyto(out[w + a : w + min(a + piece, n)],
                            host[o + a : o + min(a + piece, n)]),
        range(0, n, piece)))
