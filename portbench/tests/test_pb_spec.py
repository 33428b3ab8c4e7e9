"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a traffic mix, a per-layer metric and a cell by name."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(pending=False):
    """BENCHMARK.json, with pending.json's cells added when asked."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    if pending:
        with open(os.path.join(BENCH, "pending.json")) as f:
            p = json.load(f)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            b[key] += p[key]
    return b


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


@pytest.mark.parametrize("pending", [False, True])
def test_benchmark_json_keeps_the_contract(pending):
    b = _bench(pending)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][1:] == ["portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(cfgs) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"]) and 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert _line(w["why"])
    assert {w["config"] for w in b["workloads"]} == set(cfgs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        mine = [m for m in b["end_to_end"] if cell in m.get("workloads",
                                                            [cell])]
        assert any(m["name"] == "setup_s" for m in mine) and len(mine) >= 2
        moved = {m["name"] for m in mine}
        assert any(cell in m.get("workloads", [cell]) and m["moves"] in moved
                   for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("pending", [False, True])
def test_every_cell_resolves(pending):
    from harness import spec

    b = _bench(pending)
    for w in b["workloads"]:
        cell = spec.Cell(b, w["name"])
        assert cell.make is not None and cell.traffic["entry"]
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}


def test_unknown_cell_is_refused(small_root, capsys):
    rc, result, err = run_cell(small_root, "no-such.cell", capsys)
    assert rc != 0 and result is None and "no-such.cell" in err


def test_added_files_are_found_by_name(tmp_path, capsys):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as new files and entries only, in a copy of the benchmark."""
    from conftest import copy_tree

    root = copy_tree(tmp_path)
    bench = os.path.join(root, os.path.basename(BENCH))
    cfg = os.path.join(bench, "configs")
    with open(os.path.join(cfg, "sorted-i32.json")) as f:
        c = json.load(f)
    c["name"] = "sorted-i32-copy"
    with open(os.path.join(cfg, "sorted-i32-copy.json"), "w") as f:
        json.dump(c, f)
    shutil.copy(os.path.join(cfg, "sorted-i32.py"),
                os.path.join(cfg, "sorted-i32-copy.py"))
    with open(os.path.join(bench, "traffic", "decode.json")) as f:
        t = json.load(f)
    t["name"] = "decode-twice"
    t["distinct_inputs"] = 2
    with open(os.path.join(bench, "traffic", "decode-twice.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(bench, "metrics", "calls_per_s.decompress.py"),
              "w") as f:
        f.write("def read(run):\n    return run.calls / run.window_s\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "sorted-i32-copy", "source": "x",
                         "file": "portbench/configs/sorted-i32-copy.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "sorted-i32-copy.decode-twice",
                           "config": "sorted-i32-copy",
                           "traffic": "decode-twice", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "decompress_gbps":
            m["workloads"].append("sorted-i32-copy.decode-twice")
    b["per_layer"].append({"name": "calls_per_s.decompress", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "decompress_gbps",
                           "workloads": ["sorted-i32-copy.decode-twice"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)

    rc, result, _ = run_cell(root, "sorted-i32-copy.decode-twice", capsys)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"decompress_gbps", "setup_s"}
    rc, result, _ = run_cell(root, "sorted-i32-copy.decode-twice", capsys,
                             trace=1)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["calls_per_s.decompress"]["value"] > 0


@pytest.mark.parametrize("name", ["sorted-i32", "code-text"])
def test_generators_repeat_from_the_seed(name):
    import torch

    from harness import spec

    make = spec.load_module(os.path.join(BENCH, "configs", name + ".py"),
                            "gen_" + name.replace("-", "_")).make
    a = make(2**31 + 7, 0, 1 << 16, torch.device("cpu"))
    assert a.dtype == torch.uint8 and a.numel() == 1 << 16
    assert torch.equal(a, make(2**31 + 7, 0, 1 << 16, torch.device("cpu")))
    assert not torch.equal(a, make(2**31 + 7, 1, 1 << 16,
                                   torch.device("cpu")))
    if name == "sorted-i32":
        v = a.view(torch.int32)
        assert bool((v[1:] >= v[:-1]).all()) and int(v.max()) < 2**30
