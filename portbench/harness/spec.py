"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of "workloads") names a configuration and a traffic mix.
The configuration is configs/<name>.json with its data generator
configs/<name>.py beside it; the traffic mix is traffic/<name>.json, whose
"entry" names the entry point of the program it drives, entries/<entry>.py;
a per-layer metric is metrics/<name>.py. Adding any of them is adding files
and entries: nothing here lists them.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(Exception):
    """A name that BENCHMARK.json or its files do not resolve."""


def load_module(path: str, name: str):
    """The Python file at path, imported as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    if not os.path.exists(path):
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with what it names: config (the
    configuration's JSON), make (its generator's make function), traffic
    (the traffic mix's JSON), entry (its entry point's class), end_to_end
    and per_layer (the metrics that this cell reports, as BENCHMARK.json
    gives them)."""

    def __init__(self, bench: dict, name: str, bench_dir: str = BENCH_DIR):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                            f"(there are {sorted(cells)})")
        self.workload = w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        if w["config"] not in configs:
            raise SpecError(f"workload {name!r}: no config {w['config']!r}")
        cfg_dir = os.path.join(bench_dir, "configs")
        self.config = _json(os.path.join(cfg_dir, w["config"] + ".json"))
        gen = os.path.join(cfg_dir, w["config"] + ".py")
        if not os.path.exists(gen):
            raise SpecError(f"missing generator configs/{w['config']}.py")
        self.make = load_module(gen, "pb_config_" + w["config"]).make
        self.traffic = _json(os.path.join(bench_dir, "traffic",
                                          w["traffic"] + ".json"))
        entry = os.path.join(bench_dir, "entries",
                             str(self.traffic.get("entry")) + ".py")
        if not os.path.exists(entry):
            raise SpecError(f"traffic {w['traffic']!r}: missing entry point "
                            f"entries/{self.traffic.get('entry')}.py")
        self.entry = load_module(entry, "pb_entry_" + self.traffic["entry"]
                                 ).ENTRY

        def ours(m):
            return name in m["workloads"] if "workloads" in m else None

        self.end_to_end = [m for m in bench["end_to_end"]
                           if ours(m) in (True, None)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if ours(m) or (ours(m) is None and m["moves"] in e2e)]
        self.readers = {}
        for m in self.per_layer:
            path = os.path.join(bench_dir, "metrics", m["name"] + ".py")
            if not os.path.exists(path):
                raise SpecError(f"missing reader metrics/{m['name']}.py")
            self.readers[m["name"]] = load_module(
                path, "pb_metric_" + m["name"].replace(".", "_")).read


def load(root: str = ROOT) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return _json(os.path.join(root, "BENCHMARK.json"))
