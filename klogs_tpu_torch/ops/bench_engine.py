"""Time a tree's engine and CLI end to end, through its own
``chip_smoke.py``: the ``engine`` phase (1M FakeCluster lines in
131072-line batches, then 2000 lines of 4-192 KiB), the ``cli`` phase
(``app.run_async`` over 256 pods x 4000 lines, ``--match`` x32) and the
``engine_k1024`` phase (the gated engine at 1024 patterns, and the same
frames K1-only), each held against the ``re`` oracle as chip_smoke holds
them:

    python3 klogs_tpu_torch/ops/bench_engine.py [--tree DIR] [--label L]
        [--phases engine,cli,k1024,loop,follow,backfill_a]

``--phases`` picks among those (default ``engine,cli,k1024``) and four
more: three that time the collector's loop, ``loop`` (the cli cell once
more under cProfile: the own and cumulative ms of ``FramedBatcher.feed``
and ``take``, ``join_kept_framed``, ``frame_lines``, ``split_frame`` and
``bytes.join``), ``follow`` (chip_smoke's follow phase: 1000 streams,
20 s) and ``backfill_a`` (chip_smoke's backfill run (a): 4M lines in 8
rotated gzip sets at 32 patterns); and ``build1024``, the construction
of the 1024-pattern engine (``GpuEngineFilter(make_patterns(1024))``,
three times: seconds each and the card memory it holds).

``--tree`` is the root of the checkout whose ``chip_smoke.py`` and
``klogs_tpu_torch`` run (default: the one holding this file), so two
trees are compared on one card by running the script once per tree, in
turns (``--tree dist/prev`` for an unpacked ``git archive`` of the
parent). It needs a CUDA device and nvcc. Each phase prints its own JSON
line; the last line sums them up for the tree.
"""

import argparse
import json
import os
import sys


LOOP_FUNCTIONS = {("framer.py", "feed"), ("framer.py", "take"),
                  ("framer.py", "join_kept_framed"), ("base.py", "frame_lines"),
                  ("base.py", "split_frame")}


def loop_costs(cs, app, cli, term, FakeCluster, np, dev) -> dict:
    """The cli cell under cProfile: the loop's framing and joining
    functions, their own and cumulative ms and calls."""
    import asyncio
    import cProfile
    import io
    import pstats
    import tempfile
    import time

    fc, n_lines = cs.cli_cluster(np, FakeCluster)
    argv = ["-n", "default", "-a", "-p", ""]
    for p in cs.PATTERNS:
        argv += ["--match", p]
    with tempfile.TemporaryDirectory() as out_dir:
        argv[4] = out_dir
        opts = cli.parse_args(argv)
        term.set_ui_stream(io.StringIO())
        cp = cProfile.Profile()
        try:
            t0 = time.perf_counter()
            cp.enable()
            rc = asyncio.run(app.run_async(opts, backend=fc, device=dev))
            cp.disable()
            seconds = time.perf_counter() - t0
        finally:
            term.set_ui_stream(None)
    funcs = {}
    for (fn, _, name), (_, calls, own, cum, _) in pstats.Stats(
            cp).stats.items():
        key = (os.path.basename(fn), name)
        if key in LOOP_FUNCTIONS:
            label = name
        elif name == "<method 'join' of 'bytes' objects>":
            label = "bytes.join"
        else:
            continue
        funcs[label] = {"own_ms": own * 1e3, "cum_ms": cum * 1e3,
                        "calls": calls}
    return dict(rc=rc, seconds=seconds, lines_per_s=n_lines / seconds,
                functions=funcs)


def backfill_a(cs, torch, np, nk, pack, bits, app, cli, term, synthetic_line,
               dev) -> dict:
    """chip_smoke's backfill run (a): the 32 patterns over 8 rotated gzip
    sets of 4M lines, files held against the oracle."""
    import shutil
    import tempfile

    from klogs_tpu_torch.sources.base import safe_group_name
    from klogs_tpu_torch.utils.naming import log_file_name

    root = tempfile.mkdtemp(prefix="klogs-bench-backfill-")
    try:
        corpus = cs.backfill_corpus(np, synthetic_line, root, 4_000_000)
        verdicts = cs.corpus_verdicts(corpus, cs.PATTERNS)
        gz = os.path.join(root, "gz")
        names = [log_file_name(safe_group_name(os.path.join(
            gz, f"app-{s:02d}.log")), "archive")
            for s in range(len(corpus["sets"]))]
        total = sum(len(lines) for lines in corpus["sets"])
        run = cs.backfill_run(torch, nk, pack, bits, app, cli, term, dev,
                              "k32_gzip", [gz], cs.PATTERNS,
                              cs.expected_files(corpus, verdicts, names),
                              total, [os.path.join(gz, "app-*.log.2.gz")])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if run["rc"] != 0 or run["mismatched_files"] or not run["counts_ok"]:
        raise AssertionError(f"backfill (a) failed: {run}")
    return run


def build_k1024(cs, torch, gpu, FilterStats, dev, turns: int = 3) -> dict:
    """The 1024-pattern engine built ``turns`` times: the seconds of
    each construction (to a synchronised card) and the card memory the
    last one holds (``torch.cuda.memory_allocated`` before and after)."""
    import gc
    import time

    pats = cs.make_patterns(1024)
    seconds, held = [], 0
    for _ in range(turns):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        eng = gpu.GpuEngineFilter(pats, device=dev, stats=FilterStats())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        held = torch.cuda.memory_allocated(dev) - before
        del eng
    return dict(seconds=seconds, bytes=held)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="")
    ap.add_argument("--phases", default="engine,cli,k1024",
                    help="comma-separated: engine, cli, k1024, loop, "
                    "follow, backfill_a, build1024")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_engine: needs a CUDA device", file=sys.stderr)
        return 2
    import resource

    # The follow phase holds a thousand log files open at once.
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < 4096:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(hard, 4096), hard))
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
    out = {"tree": label}
    if "engine" in phases:
        eng = cs.engine_phase(torch, np, nk, gpu.GpuEngineFilter,
                              frame_lines, synthetic_line, dev)
        out.update(engine_short_lines_per_s=eng["short_lines_per_s"],
                   engine_dispatch_s=eng["dispatch_s"],
                   engine_fetch_s=eng["fetch_s"],
                   engine_batches=len(eng["frames"]),
                   engine_device_busy=eng["profile"]["device_busy"],
                   engine_long_lines_per_s=eng["long_lines_per_s"])
        del eng
    if "cli" in phases:
        run = cs.cli_phase(torch, np, nk, app, cli, term, FakeCluster, dev)
        out.update(cli_lines_per_s=run["lines_per_s"],
                   cli_seconds=run["seconds"])
    if "loop" in phases:
        loop = loop_costs(cs, app, cli, term, FakeCluster, np, dev)
        print(json.dumps({"phase": "loop", **loop}), flush=True)
        out.update(loop_lines_per_s=loop["lines_per_s"],
                   loop_functions=loop["functions"])
    if "follow" in phases:
        from klogs_tpu_torch.ops import pack

        fol = cs.follow_phase(torch, np, nk, pack, app, cli, term,
                              FakeCluster, synthetic_line, dev)
        out.update(follow_sustained_lines_per_s=fol["sustained_lines_per_s"],
                   follow_p50_ms=fol["match_to_file_p50_ms"])
    if "backfill_a" in phases:
        from klogs_tpu_torch.ops import bits, pack

        bf = backfill_a(cs, torch, np, nk, pack, bits, app, cli, term,
                        synthetic_line, dev)
        print(json.dumps({"phase": "backfill_a", **{
            k: v for k, v in bf.items()
            if k not in ("k1_batches", "k2_batches", "pack_batches",
                         "k3_batches")}}), flush=True)
        out.update(backfill_a_lines_per_s=bf["lines_per_s"],
                   backfill_a_host_top=bf["profile"]["host_top"][:6])
    if "build1024" in phases:
        os.environ["KLOGS_MAX_PATTERN_POSITIONS"] = "65536"
        b = build_k1024(cs, torch, gpu, FilterStats, dev)
        print(json.dumps({"phase": "build1024", **b}), flush=True)
        out.update(build1024_s=b["seconds"], build1024_bytes=b["bytes"])
    if "k1024" in phases:
        os.environ["KLOGS_MAX_PATTERN_POSITIONS"] = "65536"
        k1024 = gpu.GpuEngineFilter(cs.make_patterns(1024), device=dev,
                                    stats=FilterStats())
        ek = cs.engine_k1024_phase(torch, np, nk, gpu, frame_lines,
                                   synthetic_line, k1024, dev)
        out.update(
            k1024_short_lines_per_s=ek["short_lines_per_s"],
            k1024_device_busy=ek["profile"]["device_busy"],
            k1024_k1_only_short_lines_per_s=ek["k1_only_short_lines_per_s"],
            k1024_long_lines_per_s=ek["long_lines_per_s"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
