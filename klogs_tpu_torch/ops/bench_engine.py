"""Time a tree's engine and CLI end to end, through its own
``chip_smoke.py``: the ``engine`` phase (1M FakeCluster lines in
131072-line batches, then 2000 lines of 4-192 KiB), the ``cli`` phase
(``app.run_async`` over 256 pods x 4000 lines, ``--match`` x32) and the
``engine_k1024`` phase (the gated engine at 1024 patterns, and the same
frames K1-only), each held against the ``re`` oracle as chip_smoke holds
them:

    python3 klogs_tpu_torch/ops/bench_engine.py [--tree DIR] [--label L]

``--tree`` is the root of the checkout whose ``chip_smoke.py`` and
``klogs_tpu_torch`` run (default: the one holding this file), so two
trees are compared on one card by running the script once per tree, in
turns (``--tree dist/prev`` for an unpacked ``git archive`` of the
parent). It needs a CUDA device and nvcc. Each phase prints its own JSON
line; the last line sums them up for the tree: short and long lines/s,
host dispatch seconds and the device's busy share of a profiled batch.
"""

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_engine: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster, synthetic_line
    from klogs_tpu_torch.filters import gpu
    from klogs_tpu_torch.filters.base import FilterStats, frame_lines
    from klogs_tpu_torch.ops import nfa_kernels as nk
    from klogs_tpu_torch.ui import term

    for mod in (cs, gpu):
        if not os.path.abspath(mod.__file__).startswith(tree + os.sep):
            raise RuntimeError(f"{mod.__name__} imported from {mod.__file__}, "
                               f"not from {tree}")
    label = args.label or tree
    print(json.dumps({"tree": label}), flush=True)
    dev = torch.device("cuda", 0)
    eng = cs.engine_phase(torch, np, nk, gpu.GpuEngineFilter, frame_lines,
                          synthetic_line, dev)
    run = cs.cli_phase(torch, np, nk, app, cli, term, FakeCluster, dev)
    os.environ["KLOGS_MAX_PATTERN_POSITIONS"] = "65536"
    k1024 = gpu.GpuEngineFilter(cs.make_patterns(1024), device=dev,
                                stats=FilterStats())
    ek = cs.engine_k1024_phase(torch, np, nk, gpu, frame_lines,
                               synthetic_line, k1024, dev)
    print(json.dumps({
        "tree": label,
        "engine_short_lines_per_s": eng["short_lines_per_s"],
        "engine_dispatch_s": eng["dispatch_s"],
        "engine_fetch_s": eng["fetch_s"],
        "engine_batches": len(eng["frames"]),
        "engine_device_busy": eng["profile"]["device_busy"],
        "engine_long_lines_per_s": eng["long_lines_per_s"],
        "cli_lines_per_s": run["lines_per_s"],
        "cli_seconds": run["seconds"],
        "k1024_short_lines_per_s": ek["short_lines_per_s"],
        "k1024_device_busy": ek["profile"]["device_busy"],
        "k1024_k1_only_short_lines_per_s": ek["k1_only_short_lines_per_s"],
        "k1024_long_lines_per_s": ek["long_lines_per_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
