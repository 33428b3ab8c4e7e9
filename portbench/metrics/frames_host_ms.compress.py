"""Host milliseconds of the program's span around a batched device frame
compress, "stn.compress_frames_device" (engine.compress_frames_device, entry
to return: argument checks, header, allocations and the one K1 launch,
whose span is its child), the mean over the traced window's calls. A
program without the span gives nothing."""


def read(run):
    if run.op != "compress":
        return None
    try:
        from stenos_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.report()["spans"].get("stn.compress_frames_device")
    if not s or not s["calls"]:
        return None
    return s["host_ms"] / s["calls"]
