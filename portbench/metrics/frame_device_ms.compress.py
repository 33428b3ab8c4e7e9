"""The card's milliseconds a frame in the program's span around a batched
device frame compress, "stn.compress_frames_device": the time between the
CUDA events recorded before and after everything the call enqueues (the
look-back state's memset and K1), summed over the traced window's calls,
over the frames they wrote (the span's `frames`). Nothing without a card
(no events) or in a program without the span."""


def read(run):
    if run.op != "compress":
        return None
    try:
        from stenos_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.report()["spans"].get("stn.compress_frames_device")
    if not s or s["device_ms"] is None or not s.get("frames"):
        return None
    return s["device_ms"] / s["frames"]
