"""The card's idle milliseconds between device frame compresses, by the
program's CUDA events: per call after the first, from the event behind the
previous call's place_records launch to the one before this call's K1
launch (the spans' gaps in stenos_tpu_torch/utils/trace.py's report), the
mean over the traced window. Nothing without a card (no events) or in a
program without the recorder."""


def read(run):
    if run.op != "compress":
        return None
    try:
        from stenos_tpu_torch.utils import trace
    except ImportError:
        return None
    gaps = trace.report()["gaps_ms"].get("stn.compress_frame_device")
    if not gaps:
        return None
    return sum(gaps) / len(gaps)
