"""Run one cell of the stenos_tpu_torch benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
cells, metrics and bounds are BENCHMARK.json's; each configuration, traffic
mix and per-layer metric is a file of its own under portbench/ (see
harness/spec.py). The last line of standard output is the result, one JSON
object; the numbers compared with the reference are the last lines of
standard error. Exits non-zero, with no result, without a CUDA card.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
