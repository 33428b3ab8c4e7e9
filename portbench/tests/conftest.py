"""Shared pieces of the benchmark's CPU tests.

Run from the root of the repository: python -m pytest portbench/tests
A test that needs a CUDA card is marked `card` and skips without one.
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

SMALL = 262144  # two 128 KiB superblocks a call


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")


def copy_tree(dst, call_bytes=SMALL):
    """A checkout holding the benchmark's folder and its BENCHMARK.json with
    pending.json's cells added, every traffic mix's calls cut to
    call_bytes; returns its root."""
    dst = str(dst)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "pending.json")) as f:
        pending = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += pending[key]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    shutil.copytree(BENCH, os.path.join(dst, os.path.basename(BENCH)),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    tdir = os.path.join(dst, os.path.basename(BENCH), "traffic")
    for name in os.listdir(tdir):
        p = os.path.join(tdir, name)
        with open(p) as f:
            t = json.load(f)
        t["call_bytes"] = call_bytes
        with open(p, "w") as f:
            json.dump(t, f)
    return dst


@pytest.fixture
def small_root(tmp_path):
    return copy_tree(tmp_path)


@pytest.fixture
def host_text(monkeypatch):
    """stenos_tpu_torch.decompress through the port's host path: the text
    cell's plain sequence decode takes seconds a superblock on a CPU."""
    import stenos_tpu_torch as st

    orig = st.decompress
    monkeypatch.setattr(st, "decompress", lambda frame, bytesoftype,
                        **kw: orig(frame, bytesoftype, engine=None))


def run_cell(root, workload, capsys, seed=5, trace=0, patch=None,
             seconds=0.2):
    """One run of a cell on the CPU in root: (exit code, result or None,
    standard error)."""
    from harness.cli import main

    rc = main(["--workload", workload, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], allow_cpu=True,
              patch=patch, root=root)
    out, err = capsys.readouterr()
    lines = [line for line in out.splitlines() if line.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err
