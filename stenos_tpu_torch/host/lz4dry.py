"""LZ4 dry-run size estimator (SPEC.md §5) — drives method selection.

lz4_guess_size/lz4_guess_ratio (lz4dry.cpp:661-855, LZ4 1.8.1 greedy match
loop with size-only accounting) run in the native host runtime; the port
always builds it, so there is no pure-python tier.
"""


def lz4_guess_size(data, acceleration: int) -> int:
    from ..native import load

    return load().lz4_guess_size(data, acceleration)


def lz4_guess_ratio(data, acceleration: int) -> float:
    n = len(data)
    return n / lz4_guess_size(data, acceleration)
