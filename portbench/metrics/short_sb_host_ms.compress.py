"""Host milliseconds of the program's span around a column's short
superblock, "stn.short_superblock" (engine.compress_frame_device through
ops/encode_kernel.encode_column_frame: the launch of encode_short, which
encodes the partial segment; on the small-input route the host's libzstd
step), the mean over the traced window's calls. A program without the
span gives nothing."""


def read(run):
    if run.op != "compress":
        return None
    try:
        from stenos_tpu_torch.utils import trace
    except ImportError:
        return None
    s = trace.report()["spans"].get("stn.short_superblock")
    if not s or not s["calls"]:
        return None
    return s["host_ms"] / s["calls"]
