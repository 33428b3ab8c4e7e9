"""The card's milliseconds in the program's span around a column's short
superblock, "stn.short_superblock": between the CUDA events recorded before
and after everything the short superblock enqueues (encode_short, which
encodes the partial segment), the mean over the traced window's calls.
Nothing without a card (no events) or in a program without the span."""


def read(run):
    if run.op != "compress":
        return None
    try:
        from stenos_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.report()["spans"].get("stn.short_superblock")
    if not s or not s["calls"] or s["device_ms"] is None:
        return None
    return s["device_ms"] / s["calls"]
