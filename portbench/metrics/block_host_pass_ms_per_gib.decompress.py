"""Host milliseconds per GiB decoded of the block decode's native host
pass: engine.timing's unpack_ms (libzstd on residuals) + parse_ms (the row
parse) of every batch (engine.prepare_blocks), over the traced window."""


def read(run):
    t = run.engine_timing
    if run.op != "decompress" or not t or not run.raw_bytes:
        return None
    ms = sum(b["times"].get("unpack_ms", 0.0) + b["times"].get("parse_ms", 0.0)
             for b in t)
    return ms / (run.raw_bytes / 2**30)
