"""The compress calls' share of their roofline, in %: the least time of the
window's bytes (each input byte read once, each frame byte written once, at
the card's HBM bandwidth) over the summed device time of every kernel the
profiler saw in the traced window (memcpy and memset are not kernels)."""

from harness.roofline import share_pct


def read(run):
    if run.op != "compress" or run.trace is None:
        return None
    return share_pct(run.raw_bytes, run.coded_bytes, run.device_kind,
                     run.trace["kernel_s"])
