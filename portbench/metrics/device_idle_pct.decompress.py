"""The share of the traced window, in %, in which no operation (kernel,
memcpy, memset) ran on the card, from torch.profiler's trace of the decompress
calls."""


def read(run):
    tr = run.trace
    if run.op != "decompress" or tr is None or not tr["window_s"] \
            or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
