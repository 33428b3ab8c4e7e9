"""Runs of the cells on the CPU at a small size: a sound run is correct,
the control and every planted fault are not, the last line has the
contract's keys, no module of JAX or the JAX package is loaded, and without
a card the command fails with no result."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, run_cell

CELLS = ["sorted-i32.device-frames", "sorted-i32.decode", "code-text.decode",
         "sorted-i32.restore"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.usefixtures("host_text")
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(small_root, capsys, cell, trace):
    rc, r, err = run_cell(small_root, cell, capsys, trace=trace)
    assert rc == 0 and r["correct"] and r["failed"] == 0 and r["attempted"]
    extra = ["counters", "breakdown"] if trace else []
    assert list(r) == KEYS + extra + ["check"]
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
    else:
        assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    for name, v in r["check"].items():
        assert f"check {name} {v['value']} limit {v['limit']}" in err
    assert err.rstrip().splitlines()[-1].startswith("check ")


@pytest.mark.usefixtures("host_text")
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered"])
def test_control_and_faults_are_not_correct(small_root, capsys, cell, mode):
    from harness.controls import install

    rc, r, _ = run_cell(small_root, cell, capsys, patch=install(mode, 5))
    assert rc == 0 and r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["check"].values())


def test_a_raising_call_counts_as_failed(small_root, capsys):
    def patch(entry):
        def fn(k):
            raise RuntimeError("planted")
        entry.fn = fn

    rc, r, err = run_cell(small_root, "sorted-i32.restore", capsys,
                          patch=patch)
    assert rc == 0 and r["correct"] is False
    assert r["failed"] == r["attempted"] > 0 and "planted" in err


def test_a_loaded_jax_module_refuses_the_result(small_root, capsys,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "stenos_tpu", type(sys)("stenos_tpu"))
    rc, r, err = run_cell(small_root, "sorted-i32.restore", capsys)
    assert rc != 0 and r is None and "stenos_tpu" in err


def test_no_module_of_jax_or_the_jax_package_is_imported(small_root):
    """A whole run in a fresh process, then every module the benchmark has,
    compared by whole top-level names."""
    code = f"""
import glob, os, sys
sys.path[:0] = [{os.path.join(ROOT, 'portbench')!r}, {ROOT!r}]
from harness.cli import main, forbidden_modules
from harness.spec import load_module
rc = main(['--workload', 'sorted-i32.decode', '--seed', '3', '--seconds',
           '0.2', '--trace', '1'], allow_cpu=True, root={small_root!r})
assert rc == 0, rc
for p in glob.glob({os.path.join(ROOT, 'portbench', '**', '*.py')!r},
                   recursive=True):
    if '/tests/' not in p and not p.endswith(('run.py', 'control.py')):
        load_module(p, 'm_' + str(abs(hash(p))))
print('FOUND', forbidden_modules())
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "FOUND []"


def test_without_a_card_the_command_fails_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "sorted-i32.device-frames", "--seed", "3",
                        "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=600)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
    assert "CUDA" in r.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sorted-i32.device-frames"])
def test_cell_runs_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    assert json.loads(r.stdout.splitlines()[-1])["correct"]


def test_benchmark_files_alone_fail_with_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder only: the
    program is missing, so the run fails and prints no result."""
    from conftest import copy_tree

    root = copy_tree(tmp_path)
    code = f"""
import sys
sys.path[:0] = [{os.path.join(root, 'portbench')!r}, {root!r}]
from harness.cli import main
sys.exit(main(['--workload', 'sorted-i32.device-frames', '--seed', '3',
               '--seconds', '0.2', '--trace', '0'], allow_cpu=True,
              root={root!r}))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, timeout=600)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
    assert "stenos_tpu_torch" in r.stderr
