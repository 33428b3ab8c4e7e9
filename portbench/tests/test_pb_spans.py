"""The per-layer metrics read from the program's own spans
(stenos_tpu_torch/utils/trace.py) in a traced run on the CPU: the device
path's host time is there, the card's idle time between calls (CUDA events)
is not, and a program without the recorder leaves both out."""

import sys

from conftest import run_cell

CELL = "sorted-i32.device-frames"
SPAN_METRICS = ("device_path_host_ms.compress", "interframe_idle_ms.compress")


def test_a_traced_run_reads_the_program_spans(small_root, capsys):
    rc, r, _ = run_cell(small_root, CELL, capsys, trace=1)
    assert rc == 0 and r["correct"]
    m = r["metrics"]
    assert m["device_path_host_ms.compress"]["value"] > 0
    assert m["device_path_host_ms.compress"]["unit"] == "ms"
    assert "interframe_idle_ms.compress" not in m


def test_an_untraced_run_reports_no_span_metric(small_root, capsys):
    rc, r, _ = run_cell(small_root, CELL, capsys, trace=0)
    assert rc == 0 and r["correct"]
    assert not set(SPAN_METRICS) & set(r["metrics"])


def test_a_program_without_the_recorder_gives_nothing(small_root, capsys,
                                                      monkeypatch):
    """As the parent commit's program: the readers find no recorder to
    read, and the run leaves the two metrics out."""
    import stenos_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "stenos_tpu_torch.utils.trace", None)
    rc, r, _ = run_cell(small_root, CELL, capsys, trace=1)
    assert rc == 0 and r["correct"]
    assert not set(SPAN_METRICS) & set(r["metrics"])
