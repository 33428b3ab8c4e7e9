"""Host milliseconds per GiB decoded of the zstd stage's host pass
(entropy/device_decode.py's step "host_pass", native stn_zstd_prep_batch),
over the traced window. device_decode.timing ends each step in a
synchronize, so the traced run loses the steps' overlap."""


def read(run):
    t = run.zstd_timing
    if run.op != "decompress" or not t or "host_pass" not in t \
            or not run.raw_bytes:
        return None
    return t["host_pass"] * 1e3 / (run.raw_bytes / 2**30)
