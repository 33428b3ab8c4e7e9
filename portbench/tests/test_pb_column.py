"""The ts-f64.device-column cell on the CPU at copy_tree's size (columns of
call_bytes / 8 - d_k samples, so a short superblock each): a sound run is
correct, the control and every planted fault are not, a traced run reports
the short superblock's span metrics that a CPU can give, a program without
the span gives none, the generator repeats from its seed, and no module of
JAX or the JAX package is loaded. On a card, the cell runs and its traced
run reports every new metric."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, SMALL, run_cell

CELL = "ts-f64.device-column"
SPAN_METRICS = ("short_sb_device_ms.compress", "short_sb_host_ms.compress",
                "encode_short_roofline.compress")


def _entry(seed):
    """The cell's entry at copy_tree's size, before its set-up."""
    import torch

    from harness import spec

    cell = spec.Cell(spec.load(), CELL)
    traffic = dict(cell.traffic, call_bytes=SMALL)
    return cell.entry(cell.config, traffic, seed, torch.device("cpu"),
                      cell.make, None)


def test_columns_are_ragged_and_repeat_from_the_seed():
    e = _entry(2**31 + 9)
    assert e.sizes == _entry(2**31 + 9).sizes != _entry(2**31 + 10).sizes
    for n in e.sizes:
        assert n % 8 == 0 and n % 131072
        assert SMALL - 8 * 7152 <= n <= SMALL - 8


def test_generator_repeats_from_the_seed():
    import torch

    from harness import spec

    make = spec.load_module(os.path.join(BENCH, "configs", "ts-f64.py"),
                            "gen_ts_f64").make
    a = make(2**31 + 7, 0, 1 << 16, torch.device("cpu"))
    assert a.dtype == torch.uint8 and a.numel() == 1 << 16
    assert torch.equal(a, make(2**31 + 7, 0, 1 << 16, torch.device("cpu")))
    assert not torch.equal(a, make(2**31 + 7, 1, 1 << 16,
                                   torch.device("cpu")))
    v = a.view(torch.float64)
    assert bool(((v > 90) & (v < 110)).all())
    # the walk's steps: the top bytes move little, the bottom ones a lot
    b = a.view(-1, 8)
    assert len(torch.unique(b[:, 7])) == 1 and len(torch.unique(b[:, 0])) > 200


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(small_root, capsys, trace):
    rc, r, err = run_cell(small_root, CELL, capsys, trace=trace,
                          seed=2**31 + 17)
    assert rc == 0 and r["correct"] and r["failed"] == 0 and r["attempted"]
    assert all(v["value"] == 0 for v in r["check"].values())
    if trace:
        m = r["metrics"]
        assert m["short_sb_host_ms.compress"]["value"] > 0
        assert m["short_sb_host_ms.compress"]["unit"] == "ms"
        # CUDA events only on a card
        assert "short_sb_device_ms.compress" not in m
        assert "encode_short_roofline.compress" not in m
    else:
        assert set(r["metrics"]) == {"compress_gbps", "compress_p95_ms",
                                     "setup_s"}


@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered"])
def test_control_and_faults_are_not_correct(small_root, capsys, mode):
    from harness.controls import install

    rc, r, _ = run_cell(small_root, CELL, capsys, patch=install(mode, 5))
    assert rc == 0 and r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["check"].values())


def test_a_program_without_the_span_gives_nothing(small_root, capsys,
                                                 monkeypatch):
    import stenos_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "stenos_tpu_torch.utils.trace", None)
    rc, r, _ = run_cell(small_root, CELL, capsys, trace=1)
    assert rc == 0 and r["correct"]
    assert not set(SPAN_METRICS) & set(r["metrics"])


def test_no_module_of_jax_or_the_jax_package_is_imported(small_root):
    code = f"""
import sys
sys.path[:0] = [{os.path.join(ROOT, 'portbench')!r}, {ROOT!r}]
from harness.cli import main, forbidden_modules
rc = main(['--workload', {CELL!r}, '--seed', '3', '--seconds', '0.2',
           '--trace', '1'], allow_cpu=True, root={small_root!r})
assert rc == 0, rc
print('FOUND', forbidden_modules())
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "FOUND []"


@pytest.mark.card
def test_cell_runs_on_the_card(card):
    for trace in (0, 1):
        r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            CELL, "--seed", "2147483659", "--seconds", "2",
                            "--trace", str(trace)], capture_output=True,
                           text=True, cwd=ROOT, timeout=1200)
        assert r.returncode == 0, r.stderr[-4000:]
        result = json.loads(r.stdout.splitlines()[-1])
        assert result["correct"]
        if trace:
            assert set(SPAN_METRICS) <= set(result["metrics"])
