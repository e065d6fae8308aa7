"""What a run reads from data: ``BENCHMARK.json`` at the checkout's root
and the files it names by name, under this folder.

- a cell's configuration: ``configs/<config>.json``
- its traffic mix: ``traffic/<traffic>.json``, generated by the module
  ``generators/<kind>.py`` that the mix's ``kind`` names
- each per-layer metric: its reader, ``metrics/<name>.py``

Modules are loaded from their files, so a cell, a mix or a metric is
added with files and entries alone.
"""

import hashlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: "list[dict]"
    per_layer: "list[dict]"
    bench_dir: str
    root: str


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT,
              bench_dir: str = BENCH_DIR) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    config = load_json(os.path.join(bench_dir, "configs",
                                    w["config"] + ".json"))
    mix = load_json(os.path.join(bench_dir, "traffic",
                                 w["traffic"] + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)],
                bench_dir=bench_dir, root=root)


def load_module(path: str):
    """The module in ``path``, loaded once a process."""
    name = "portbench_file_" + hashlib.sha1(path.encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def generator(bench_dir: str, kind: str):
    return load_module(os.path.join(bench_dir, "generators", kind + ".py"))


def reader(bench_dir: str, metric: str):
    return load_module(os.path.join(bench_dir, "metrics", metric + ".py"))
