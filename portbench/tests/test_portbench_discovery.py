"""A cell, a configuration, a traffic mix and a per-layer metric added as
files and entries alone are found and run: nothing of the harness is
edited."""

import json
import os

from conftest import TINY_SHORT, add_cell, last_json

from portbench import run

READER = '''"""A test's metric: the MatchFramed RPCs the window's spans saw."""


def read(tr):
    n = len([s for s in tr.spans_named("rpc.server")
             if s["attrs"].get("method") == "MatchFramed"])
    return float(n) if n else None
'''


def test_new_files_and_entries_make_a_new_cell_run(bench_copy, capsys):
    root, bench_dir = bench_copy
    with open(os.path.join(bench_dir, "metrics", "rpcs_seen.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(bench_dir, "configs", "ops32.json")) as f:
        config = json.load(f)
    config.update(name="three", patterns=["panic:", r"latency=49\dms",
                                          "oom-killer"])
    with open(os.path.join(bench_dir, "configs", "three.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "rpcs_seen", "unit": "rpcs", "better": "higher",
        "source": "program_span", "layer": "service",
        "moves": "frame_p95_ms", "workloads": []})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    mix = dict(TINY_SHORT, name="tinynew")
    add_cell(root, "three.tinynew", "three", mix,
             metrics=("rpcs_seen", "coalescer_group_lines"))

    args = ["--workload", "three.tinynew", "--seed", "2147483999",
            "--seconds", "2"]
    assert run.main(args + ["--trace", "0"], root=root, bench_dir=bench_dir,
                    device="cpu") == 0
    plain = last_json(capsys.readouterr().out)
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"lines_per_s", "frame_p95_ms",
                                     "setup_s"}
    assert plain["metrics"]["lines_per_s"]["value"] > 0
    assert plain["check"]["reference_kept"] > 0
    assert list(plain)[-1] == "check"

    assert run.main(args + ["--trace", "1"], root=root, bench_dir=bench_dir,
                    device="cpu") == 0
    traced = last_json(capsys.readouterr().out)
    assert traced["correct"] is True
    assert traced["metrics"]["rpcs_seen"]["value"] > 0
    assert traced["metrics"]["rpcs_seen"]["unit"] == "rpcs"
    assert traced["metrics"]["coalescer_group_lines"]["value"] >= 256
    # Metrics this cell is not listed for are not read.
    assert "rpc_server_ms_p50" not in traced["metrics"]
    assert "breakdown" in traced
