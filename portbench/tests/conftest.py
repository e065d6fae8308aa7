"""Helpers of the benchmark's CPU tests: a copy of the benchmark with
small cells added as files and entries, run on the CPU (the kernels'
plain versions) in this process."""

import json
import os
import shutil

import pytest

from portbench import spec

TINY_SHORT = {"name": "tinyshort", "kind": "frames", "collectors": 2,
              "flows_per_collector": 2, "frame_lines": 256,
              "pool_frames": 4, "long_every": 0, "check_short_lines": "all",
              "check_long_lines": 0}


def add_cell(root: str, cell: str, config: str, mix: dict,
             metrics: "tuple[str, ...]" = ()) -> None:
    """Write ``mix`` as a traffic file and ``cell`` as an entry of the
    copy's BENCHMARK.json, reporting every end-to-end metric and
    ``metrics`` too."""
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "traffic", mix["name"] + ".json"),
              "w") as f:
        json.dump(mix, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": mix["name"], "chips": 1,
                               "why": "a CPU test's cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    for m in bench["per_layer"]:
        if m["name"] in metrics:
            m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def bench_copy(tmp_path):
    """(root, bench_dir) of a copy of BENCHMARK.json and this folder."""
    root = str(tmp_path)
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(spec.BENCH_DIR, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root, os.path.join(root, "portbench")


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])
