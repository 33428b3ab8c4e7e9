"""The decompress calls' share of their roofline, in %: the least time of
the window's bytes (each frame byte read once, each decoded byte written
once, at the card's HBM bandwidth) over the summed device time of every
kernel the profiler saw in the traced window (memcpy and memset are not
kernels)."""

from harness.roofline import share_pct


def read(run):
    if run.op != "decompress" or run.trace is None:
        return None
    return share_pct(run.coded_bytes, run.raw_bytes, run.device_kind,
                     run.trace["kernel_s"])
