"""encode_short's share of its roofline, in %: the least time of its bytes at
the card's HBM bandwidth over its time by the CUDA events of the program's
span "stn.short_superblock", summed over the traced window's calls.

Its bytes, a call: the partial segment past the short superblock's whole
blocks read once (the span's nbytes) and a segment as long written once
(the segment the kernel writes is within (bpp + 1) / 2 + 8 * bpp bytes of
its input, and shorter on compressible data). The short superblock's whole
blocks are K1's, in kernels_roofline.compress. Nothing without a card or in
a program without the span."""

from harness.roofline import share_pct


def read(run):
    if run.op != "compress":
        return None
    try:
        from stenos_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.report()["spans"].get("stn.short_superblock")
    if not s or not s["device_ms"] or not s["bytes"]:
        return None
    return share_pct(s["bytes"], s["bytes"], run.device_kind,
                     s["device_ms"] / 1e3)
