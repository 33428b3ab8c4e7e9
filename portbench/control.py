"""The control and the planted faults of a cell, on the card at the cell's
own size, several seeds in one process:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--modes control,unchanged,half,altered]

Each (mode, seed) is one run of the cell with the mode's call in the
program's place (harness/controls.py); its result line and the numbers
compared are printed as a run prints them. Every one has to read `correct`
false. The benchmark's own runs never run this.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import argparse  # noqa: E402

from harness.cli import main  # noqa: E402
from harness.controls import MODES, install  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="3")
    p.add_argument("--modes", default=",".join(MODES))
    a = p.parse_args()
    rc = 0
    for mode in a.modes.split(","):
        for seed in a.seeds.split(","):
            print(f"control.py: {a.workload} {mode} seed {seed}",
                  file=sys.stderr, flush=True)
            print(f"control.py: {a.workload} {mode} seed {seed}", flush=True)
            rc |= main(["--workload", a.workload, "--seed", seed,
                        "--seconds", a.seconds, "--trace", "0"],
                       patch=install(mode, int(seed)))
    sys.exit(rc)
