"""Host milliseconds of the program's own span around a device frame
compress, "stn.compress_frame_device" (engine.compress_frame_device, entry
to return: argument checks, header, allocations and its two kernel
launches, whose spans are its children), the mean over the traced window's
calls. The span recorder (stenos_tpu_torch/utils/trace.py) is on while the
harness sets the program's timing switches; a program without it gives
nothing."""


def read(run):
    if run.op != "compress":
        return None
    try:
        from stenos_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.report()["spans"].get("stn.compress_frame_device")
    if not s or not s["calls"]:
        return None
    return s["host_ms"] / s["calls"]
