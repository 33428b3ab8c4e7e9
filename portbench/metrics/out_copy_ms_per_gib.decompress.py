"""Host milliseconds per GiB decoded that the block decode spends copying
each batch into the output array, and waiting for the batch before's copy:
engine.timing's out_ms + out_wait_ms (frame.py's _BlockChunk), over the
traced window."""


def read(run):
    t = run.engine_timing
    if run.op != "decompress" or not t or not run.raw_bytes:
        return None
    ms = sum(b["times"].get("out_ms", 0.0) + b["times"].get("out_wait_ms", 0.0)
             for b in t)
    return ms / (run.raw_bytes / 2**30)
