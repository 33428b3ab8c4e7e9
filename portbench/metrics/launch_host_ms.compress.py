"""Host milliseconds from a compress call's entry to its return, before its
length is read: the device path's launch cost (engine.compress_frame_device:
argument checks, header, allocations, two kernel launches), by the
benchmark's clock, the mean over the traced window's calls."""


def read(run):
    if run.op != "compress" or not run.launch_s:
        return None
    return 1e3 * sum(run.launch_s) / len(run.launch_s)
