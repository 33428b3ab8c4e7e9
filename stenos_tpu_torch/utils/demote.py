"""One-shot warnings for a call that cannot do what it was asked (the port
of stenos_tpu/utils/demote.py).

The port has no fallback tiers (a kernel that does not build or launch
raises), so its one user is the timed mode: a budget below the measured
warm floor of a timed call cannot be met, and the call says so the first
time (frame.compress_generic). Set STENOS_SILENT=1 to suppress.
"""

import os
import warnings

_seen: set = set()


class DemotionWarning(UserWarning):
    """A call that runs, but not as asked (a budget it cannot meet)."""


def warn_once(key: str, msg: str, exc: BaseException | None = None) -> None:
    """Emit one DemotionWarning per (process, key); `exc` is appended so its
    cause survives into the warning."""
    if key in _seen or os.environ.get("STENOS_SILENT"):
        return
    _seen.add(key)
    if exc is not None:
        msg = f"{msg} [{type(exc).__name__}: {exc}]"
    warnings.warn(f"stenos-tpu-torch demotion: {msg}", DemotionWarning,
                  stacklevel=3)
