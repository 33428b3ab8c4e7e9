"""The control and the planted faults, each put in the place of an entry's
program call (entry.fn) after set-up. The benchmark's runs never use them:
control.py runs them on the card at a cell's own size, and the tests on the
CPU at a small one; each has to make the run's `correct` come out false.

- "control": the plain reference in the program's place, one step below
  what the configuration states (entry.control). A stenos frame states no
  precision, so the step breaks a guarantee the way a cheaper path would:
  a compress encodes at block level 0 instead of the level's block level
  2; a decode returns the data with one bit fewer a value.
- "unchanged": the call returns its output buffer as it found it (zeros).
- "half": the second half of the call's output left out (zeros).
- "altered": one byte of the output flipped where it is produced, at a
  position drawn from the seed.
The exchange between chips, the fourth kind of fault, has no place in a
one-chip cell.
"""

import numpy as np

MODES = ("control", "unchanged", "half", "altered")


def install(mode: str, seed: int):
    """patch(entry) for main(): replaces entry.fn with the mode's call."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    rng = np.random.default_rng([seed, 2])

    def patch(entry):
        orig = entry.fn
        if mode == "control":
            entry.fn = entry.control
        else:
            entry.fn = lambda k: entry.corrupt(orig(k), mode, rng)

    return patch
