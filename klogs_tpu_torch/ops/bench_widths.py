"""Time the NFA kernels at program widths off the main path, and K1 and
K4 on the main path's shapes.

The register kernels are built for 4, 8, 16 and 32 state words (S = 128,
256, 512, 1024); a program of another width up to 32 words runs padded
to the next of them. This script times both kernels on union programs
of S = 256, 384, 512 and 640 states, so a tree that pads can be held
against one built for each width. K2 runs one 4096-byte chunk of 1024
lines, and of 8 lines (the size of the long-line batches the CLI
hands it; rows without the needle). Then K2 runs the 32-pattern union
of ``chip_smoke.PATTERNS`` (400 states, run at 512) on one mid-line
4096-byte chunk of 8 and of 1024 lines, printable and random bytes,
needles in every third row, held against its plain version. Then K1
and K4, each held equal to the other, on the batches of their main
paths: the CLI's 16384 x 131 (FakeCluster lines, 1% with a
``chip_smoke`` needle), ``chip_smoke``'s w128 (131072 x 131) and w4096
(4096 x 4099) mixes at the 32 patterns, and at 1024 patterns the
131072 x 131 batch and the 256-byte bucket (2048 x 259) of
``chip_smoke.k1024_rows``. These rows give each kernel's device time
alone (torch.profiler), and K1's and K4's wrapper time by CUDA events
beside it (``wrapper_ms``). Then K3 through ``match_cls_grouped_gated``
(a name every tree has) at 1024 patterns: 8192 x 131 rows under a
seeded 5% gate, and the engine's literal sweep gate on 8192 and 131072
rows of ``chip_smoke.k1024_rows`` and on all 131072 with the gate kept
on a seeded 3% of the lines; each row gives the device time of every
hand-written kernel the wrapper ran, by name (``kernels_ms``: K3's own
kernel apart from its pair builder), K3's own (under its name), the
wrapper by CUDA events (``wrapper_ms``), and its verdicts held against
the plain version (8192 rows) or ungated K1 (``"equal"``). Last, what
ptxas reported for each kernel (registers, spills):

    python3 klogs_tpu_torch/ops/bench_widths.py [--tree DIR] [--label L] [--main | --wide]

``--tree`` is the root of the checkout whose ``klogs_tpu_torch`` is
timed (default: the one holding this file). Two trees are compared on
one card by running the script once per tree, in turns (``--tree
dist/prev`` for an unpacked ``git archive`` of the parent). It needs a
CUDA device and nvcc, and prints one JSON line per (kernel, width,
lines) or shape. ``--main`` runs the main-path rows only.

``--wide`` runs only K3 and K4 past 32 words, through wrapper names that
a tree from before their wide kernels has too: K4
(``match_cls_grouped_fused``) beside K1 on the watch-list set
(``chip_smoke.PATTERNS + [WATCH]``: 5 groups of 1152 states) over 131072
FakeCluster rows at the 128-byte bucket, and on a 1280-state set over
512 x 2051 (row 0 the dense line, as ``chip_smoke``'s s1280); then K3 on
the thousand-pattern set with the watch list (``make_patterns(1024) +
[WATCH]``: 157 groups of 1152 states) under the engine's sweep gate,
over 8192 and 131072 rows of ``chip_smoke.k1024_rows``: ``launch_gated``
alone on ``gate_pairs``' list (``kernels_ms`` by name, and CUDA events),
the pair builder and the whole wrapper by events, the verdicts held
against ungated K1.

Then (also alone with ``--past160``) K1, K4, K3 and K2g past 160 state
words, through the same wrapper names (a tree from before the
shared-memory kernels runs the generic wide kernels there, and refuses
K2g): K1 and K4 on the 32 patterns with watch lists of 700 and 1016
pods (5 groups of 176 and 256 words) over 131072 FakeCluster rows at
the 128-byte bucket, and on dense literal sets of 176 and 256 words
over 512 rows of 6144 and 8704 bytes (row 0 the dense line, as s1280);
K3 on ``make_patterns(64)`` and the 700-pod list under the engine's
sweep gate over 131072 ``k1024_rows`` rows; K2g (where the tree runs
it) and ``chunk_nfa_wide`` on the set's union over the same 8 x 4096
chunks of 8 lines of 12-16 KiB, the carry chained, the verdicts of the
two equal. K2g and K2 are timed by CUDA events a chunk, the others as
above.
"""

import argparse
import json
import os
import re
import sys

SEED = 20261016
WIDTHS = (256, 384, 512, 640)
K1_ROWS, K1_WIDTH = 16384, 256  # a CLI-sized batch at the 256-byte bucket
K2_LINES, K2_CHUNK = 1024, 4096  # one 4096-byte chunk of 1024 long lines
K2_CLI_LINES = 8  # the CLI's long-line batch (its smallest row bucket)


def patterns_for(S: int) -> list[str]:
    """Two patterns whose augmented union, and whose widest group, pad
    to S states."""
    return ["q" * (S - 70) + "z", "panic:"]


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernels_ms(torch, fn, reps: int) -> dict:
    """Mean device ms a run of ``fn`` spends in each kernel of
    ``ops/csrc/nfa_kernels.cu`` (named in an anonymous namespace there),
    by kernel name with its template arguments, by torch.profiler: the
    kernels alone, without the wrapper's own tensor ops and launch
    gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if "anonymous namespace" in e.key:
            m = re.search(r"::(\w+(?:<[^>]*>)?)", e.key)
            name = m.group(1) if m else e.key
            ms = e.self_device_time_total / 1e3 / reps
            out[name] = out.get(name, 0.0) + ms
    return out


def kernel_ms(torch, fn, reps: int) -> float:
    """The sum of ``kernels_ms``: every hand-written kernel ``fn`` ran."""
    return sum(kernels_ms(torch, fn, reps).values())


def rows(np, rng, B: int, width: int, needle: bytes):
    """Printable random rows of full width, the needle in every 64th."""
    r = rng.integers(32, 127, size=(B, width), dtype=np.uint8)
    n = min(len(needle), width)
    r[::64, :n] = np.frombuffer(needle[:n], np.uint8)
    return r, np.full(B, width, dtype=np.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="")
    ap.add_argument("--main", action="store_true",
                    help="only K1 and K4 on the main path's batches (and K3)")
    ap.add_argument("--wide", action="store_true",
                    help="only K3 and K4 past 32 words, and past 160")
    ap.add_argument("--past160", action="store_true",
                    help="only K1, K2g, K3 and K4 past 160 words")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
    from klogs_tpu_torch.ops import nfa
    from klogs_tpu_torch.ops import nfa_kernels as nk

    if not torch.cuda.is_available():
        print("bench_widths: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    label = args.label or os.path.abspath(args.tree)
    if args.wide or args.past160:
        if not args.past160:
            wide_bench(np, torch, nfa, nk, dev, label)
        past160_bench(np, torch, compile_patterns, nfa, nk, dev, label)
        return 0
    for S in () if args.main else WIDTHS:
        pats = patterns_for(S)
        needle = pats[0].encode()
        dp, live, acc = nfa.compile_grouped(pats, device=dev)
        r, lens = rows(np, rng, K1_ROWS, K1_WIDTH, needle)
        cls = nfa.classify_chunk(dp, torch.from_numpy(r).to(dev),
                                 torch.from_numpy(lens).to(dev), True, True)
        ms = cuda_ms(torch, lambda: nk.match_cls_grouped(dp, live, acc, cls),
                     10)
        print(json.dumps({"tree": label, "kernel": nk.GROUPED,
                          "states": dp.n_states, "rows": K1_ROWS,
                          "T": cls.shape[1], "ms": ms}), flush=True)
        union = compile_patterns(pats)
        prog = nfa.pack_program(nfa.augment(union), device=dev)
        r, lens = rows(np, rng, K2_LINES, K2_CHUNK, needle)
        cls = nfa.classify_chunk(prog, torch.from_numpy(r).to(dev),
                                 torch.from_numpy(lens).to(dev), True, False)
        v0 = nk.initial_state(prog, union.n_states, K2_LINES)
        # All lines, then rows 1..8 (row 0 holds the needle).
        for c, v in ((cls, v0), (cls[1:1 + K2_CLI_LINES].contiguous(),
                                 v0[:K2_CLI_LINES])):
            ms = cuda_ms(torch, lambda: nk.match_chunk_cls(
                prog, union.n_states + 1, c, v, False), 5)
            print(json.dumps({"tree": label, "kernel": nk.CHUNK,
                              "states": prog.n_states, "lines": c.shape[0],
                              "T": c.shape[1], "ms": ms,
                              "us_per_step": ms * 1e3 / c.shape[1]}),
                  flush=True)
    if not args.main:
        k2_bench32(np, torch, compile_patterns, nfa, nk, dev, label)
    main_path_bench(np, torch, nfa, nk, dev, label)
    from klogs_tpu_torch.ops import _build

    for m in re.finditer(r"entry function '([^']+)'.*?(\d+) bytes spill "
                         r"stores, (\d+) bytes spill loads.*?Used (\d+) "
                         r"registers", _build.build_logs.get("nfa_kernels", ""),
                         re.S):
        print(json.dumps({"tree": label, "ptxas": m.group(1),
                          "spill_stores": int(m.group(2)),
                          "spill_loads": int(m.group(3)),
                          "registers": int(m.group(4))}), flush=True)
    return 0


def k2_bench32(np, torch, compile_patterns, nfa, nk, dev, label: str) -> None:
    """K2 on the 32-pattern union, one chunk inside long lines (no
    BEGIN or END column), timed and held against its plain version."""
    import chip_smoke

    union = compile_patterns(chip_smoke.PATTERNS)
    prog = nfa.pack_program(nfa.augment(union), device=dev)
    live, acc = union.n_states, union.n_states + 1
    rng = np.random.default_rng(7)
    for B, printable in ((8, True), (8, False), (1024, False), (1024, True)):
        r, _ = chip_smoke.rows_with_needles(np, rng, B, K2_CHUNK, K2_CHUNK,
                                            printable=printable)
        rem = torch.full((B,), 2 * K2_CHUNK, dtype=torch.int32, device=dev)
        cls = nfa.classify_chunk(prog, torch.from_numpy(r).to(dev), rem,
                                 False, False)
        v0 = nk.initial_state(prog, live, B)
        v, m = nk.match_chunk_cls(prog, acc, cls, v0, False)
        vp, mp = nk.match_chunk_cls_plain(prog, acc, cls, v0)
        ms = cuda_ms(torch, lambda: nk.match_chunk_cls(prog, acc, cls, v0,
                                                       False), 10)
        print(json.dumps({"tree": label, "kernel": nk.CHUNK,
                          "patterns": "chip_smoke.PATTERNS",
                          "states": prog.n_states, "lines": B,
                          "T": cls.shape[1], "printable": printable,
                          "equal": bool(torch.equal(v, vp)
                                        and torch.equal(m, mp)),
                          "ms": ms, "us_per_step": ms * 1e3 / cls.shape[1]}),
              flush=True)


def main_path_rows(np, synthetic_line, B: int, seed: int):
    """[B, 128] FakeCluster rows, 1% with a chip_smoke needle."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    rows = np.zeros((B, 128), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i in range(B):
        ln = synthetic_line(f"pod-{i % 256:04d}", "c0", i,
                            chip_smoke.CLOCK + i).rstrip(b"\n")
        if i % 100 == 0:
            nd = chip_smoke.NEEDLES[(i // 100) % len(chip_smoke.NEEDLES)]
            p = int(rng.integers(0, 40))
            ln = ln[:p] + nd + ln[p:]
        ln = ln[:128]
        rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
        lens[i] = len(ln)
    return rows, lens


def w128_rows(np, synthetic_line, rng, B: int):
    """chip_smoke's w128 mix: half FakeCluster lines, half random bytes
    with planted needles."""
    import chip_smoke

    rows, lens = chip_smoke.rows_with_needles(np, rng, B, 128, 0,
                                              printable=False)
    for i in range(B // 2):
        ln = synthetic_line(f"pod-{i % 256:04d}", f"c{i % 3}", i,
                            chip_smoke.CLOCK + i).rstrip(b"\n")
        rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
        lens[i] = len(ln)
    return rows, lens


def main_path_bench(np, torch, nfa, nk, dev, label: str) -> None:
    """K1 and K4 timed one after the other on each main-path batch, each
    held equal to the other; then K3 (``k3_bench``)."""
    import chip_smoke
    from klogs_tpu_torch.cluster.fake import synthetic_line

    os.environ.setdefault("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    rng = np.random.default_rng(SEED)
    p32 = nfa.compile_grouped(chip_smoke.PATTERNS, device=dev)
    p1024 = nfa.compile_grouped(chip_smoke.make_patterns(1024), device=dev)
    cases = (
        ("cli", p32, main_path_rows(np, synthetic_line, 16384, SEED), 200),
        ("w128", p32, w128_rows(np, synthetic_line, rng, 131072), 50),
        ("w4096", p32, chip_smoke.rows_with_needles(np, rng, 4096, 4096, 2049,
                                                    printable=False), 10),
        ("k1024", p1024, chip_smoke.k1024_rows(np, synthetic_line, 131072, 128,
                                               SEED + 4), 5),
        ("k1024_b256", p1024, chip_smoke.k1024_rows(np, synthetic_line, 2048,
                                                    256, SEED + 5), 20),
    )
    for name, (dp, live, acc), (r, lens), reps in cases:
        cls = nfa.classify_chunk(dp, torch.from_numpy(r).to(dev),
                                 torch.from_numpy(lens).to(dev), True, True)

        def k1():
            return nk.match_cls_grouped(dp, live, acc, cls)

        def k4():
            return nk.match_cls_grouped_fused(dp, live, acc, cls)

        print(json.dumps({"tree": label, "case": name,
                          "rows": cls.shape[0], "T": cls.shape[1],
                          "groups": dp.follow.shape[0],
                          "equal": bool(torch.equal(k1(), k4())),
                          "matched": int(k1().sum()),
                          nk.GROUPED: kernel_ms(torch, k1, reps),
                          nk.FUSED: kernel_ms(torch, k4, reps),
                          "wrapper_ms": {nk.GROUPED: cuda_ms(torch, k1, reps),
                                         nk.FUSED: cuda_ms(torch, k4, reps)}}),
              flush=True)
    k3_bench(np, torch, nfa, nk, dev, label, rng)


def k3_bench(np, torch, nfa, nk, dev, label: str, rng) -> None:
    """K3 through ``match_cls_grouped_gated`` on the four gated batches
    at 1024 patterns (see the module's note), on the engine's own
    program and sweep tables."""
    import chip_smoke
    from klogs_tpu_torch.cluster.fake import synthetic_line
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.ops import sweep
    from klogs_tpu_torch.ops.bits import pack_bits, unpack_bits

    eng = GpuEngineFilter(chip_smoke.make_patterns(1024), device=dev)
    dp, live, acc = eng._grouped, eng._g_live, eng._g_acc
    G = dp.follow.shape[0]

    def classified(r, lens):
        r, lens = torch.from_numpy(r).to(dev), torch.from_numpy(lens).to(dev)
        return r, lens, nfa.classify_chunk(dp, r, lens, True, True)

    _, _, cls_r = classified(*chip_smoke.k1024_rows(
        np, synthetic_line, 8192, 128, SEED + 6))
    rand = pack_bits(torch.from_numpy(rng.random((8192, G)) < 0.05).to(dev))
    batch, lens, cls = classified(*chip_smoke.k1024_rows(
        np, synthetic_line, 131072, 128, SEED + 4))
    words = sweep.sweep_group_bits(eng._sweep_tables, batch, lens)
    keep = torch.from_numpy(np.random.default_rng(SEED).random(131072)
                            < 0.03).to(dev)
    kept = torch.where(keep[:, None], words, torch.zeros_like(words))
    k1 = nk.match_cls_grouped(dp, live, acc, cls)
    cases = (("k1024_gated_5pct", cls_r, rand, None),
             ("k3_sweep_8192", cls[:8192], words[:8192], None),
             ("k3_sweep", cls, words, k1),
             ("k3_sweep_kept_3pct", cls, kept, k1 & keep))
    for name, c, w, ref in cases:
        def k3():
            return nk.match_cls_grouped_gated(dp, live, acc, c, w)[0]

        if ref is None:
            ref = nk.match_cls_grouped_gated_plain(dp, live, acc, c, w)
        per = kernels_ms(torch, k3, 20)
        print(json.dumps({"tree": label, "case": name, "rows": c.shape[0],
                          "T": c.shape[1], "groups": G,
                          "pairs": int(unpack_bits(w.long(), G).sum()),
                          "equal": bool(torch.equal(k3(), ref)),
                          "kernels_ms": per,
                          nk.GATED: sum(v for k, v in per.items()
                                        if k.startswith("grouped_nfa")),
                          "wrapper_ms": cuda_ms(torch, k3, 20)}),
              flush=True)


def wide_bench(np, torch, nfa, nk, dev, label: str) -> None:
    """K4 and K3 past 32 words (see the module's note)."""
    import chip_smoke
    from klogs_tpu_torch.cluster.fake import synthetic_line
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.ops import sweep
    from klogs_tpu_torch.ops.bits import unpack_bits

    os.environ.setdefault("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    rng = np.random.default_rng(SEED)
    dense = ["q" * 1200 + "z", "panic:"]
    r, lens = chip_smoke.rows_with_needles(np, rng, 512, 2048, 0,
                                           printable=True)
    r[0, :len(dense[0])] = np.frombuffer(dense[0].encode(), np.uint8)
    lens[0] = max(lens[0], len(dense[0]))
    cases = (("watch_w128", chip_smoke.PATTERNS + [chip_smoke.WATCH],
              chip_smoke.watch_rows(np, synthetic_line, 131072, 128), 10),
             ("s1280", dense, (r, lens), 3))
    for name, pats, (r, lens), reps in cases:
        dp, live, acc = nfa.compile_grouped(pats, device=dev)
        cls = nfa.classify_chunk(dp, torch.from_numpy(r).to(dev),
                                 torch.from_numpy(lens).to(dev), True, True)

        def k1():
            return nk.match_cls_grouped(dp, live, acc, cls)

        def k4():
            return nk.match_cls_grouped_fused(dp, live, acc, cls)

        print(json.dumps({"tree": label, "case": name,
                          "rows": cls.shape[0], "T": cls.shape[1],
                          "groups": dp.follow.shape[0],
                          "states": dp.n_states,
                          "equal": bool(torch.equal(k1(), k4())),
                          "matched": int(k1().sum()),
                          "k1_kernels_ms": kernels_ms(torch, k1, reps),
                          "k4_kernels_ms": kernels_ms(torch, k4, reps),
                          "wrapper_ms": {nk.GROUPED: cuda_ms(torch, k1, reps),
                                         nk.FUSED: cuda_ms(torch, k4, reps)}}),
              flush=True)
    eng = GpuEngineFilter(chip_smoke.make_patterns(1024) + [chip_smoke.WATCH],
                          device=dev)
    dp, live, acc = eng._grouped, eng._g_live, eng._g_acc
    G = dp.follow.shape[0]
    r, lens = chip_smoke.k1024_rows(np, synthetic_line, 131072, 128,
                                    SEED + 4)
    batch, lens = torch.from_numpy(r).to(dev), torch.from_numpy(lens).to(dev)
    cls = nfa.classify_chunk(dp, batch, lens, True, True)
    words = sweep.sweep_group_bits(eng._sweep_tables, batch, lens)
    k1 = nk.match_cls_grouped(dp, live, acc, cls)
    for name, n in (("k1025_8192", 8192), ("k1025", 131072)):
        c, w = cls[:n], words[:n]
        pairs, n_pairs, _ = nk.gate_pairs(w, G)

        def launch():
            return nk.launch_gated(dp, live, acc, c, pairs, n_pairs)

        def k3():
            return nk.match_cls_grouped_gated(dp, live, acc, c, w)[0]

        print(json.dumps({"tree": label, "case": name, "rows": n,
                          "T": c.shape[1], "groups": G,
                          "states": dp.n_states,
                          "pairs": int(unpack_bits(w.long(), G).sum()),
                          "equal": bool(torch.equal(k3(), k1[:n])),
                          "matched": int(k1[:n].sum()),
                          "kernels_ms": kernels_ms(torch, launch, 5),
                          "launch_ms": cuda_ms(torch, launch, 5),
                          "pairs_ms": cuda_ms(torch, lambda: nk.gate_pairs(
                              w, G), 5),
                          "wrapper_ms": cuda_ms(torch, k3, 5)}), flush=True)


def watch_list(n: int) -> str:
    """``chip_smoke.watch_list`` (a tree's own chip_smoke may predate
    it): n pods as one alternation, 8 positions a pod."""
    return ("pod=(?:" + "|".join(f"pod-{p:04d}" for p in range(1, 2 * n, 2))
            + ")")


def dense_rows(np, rng, B: int, width: int, line: bytes):
    """``chip_smoke.rows_with_needles``' printable rows, row 0 ``line``."""
    import chip_smoke

    r, lens = chip_smoke.rows_with_needles(np, rng, B, width, 0,
                                           printable=True)
    r[0, :len(line)] = np.frombuffer(line, np.uint8)
    lens[0] = max(lens[0], len(line))
    return r, lens


def past160_bench(np, torch, compile_patterns, nfa, nk, dev,
                  label: str) -> None:
    """K1, K4, K3 and K2g past 160 words (see the module's note)."""
    import chip_smoke
    from klogs_tpu_torch.cluster.fake import synthetic_line
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.ops import sweep
    from klogs_tpu_torch.ops.bits import unpack_bits

    os.environ["KLOGS_MAX_PATTERN_POSITIONS"] = "65536"
    rng = np.random.default_rng(SEED + 160)
    watch_rows = chip_smoke.watch_rows(np, synthetic_line, 131072, 128)
    d176, d256 = "q" * 5600 + "z", "q" * 8120 + "z"
    cases = (
        ("watch700_w128", chip_smoke.PATTERNS + [watch_list(700)], watch_rows,
         5),
        ("watch1016_w128", chip_smoke.PATTERNS + [watch_list(1016)],
         watch_rows, 3),
        ("dense176", [d176, "panic:"],
         dense_rows(np, rng, 512, 6144, d176.encode()), 1),
        ("dense256", [d256, "panic:"],
         dense_rows(np, rng, 512, 8704, d256.encode()), 1))
    for name, pats, (r, lens), reps in cases:
        dp, live, acc = nfa.compile_grouped(pats, device=dev)
        cls = nfa.classify_chunk(dp, torch.from_numpy(r).to(dev),
                                 torch.from_numpy(lens).to(dev), True, True)

        def k1():
            return nk.match_cls_grouped(dp, live, acc, cls)

        def k4():
            return nk.match_cls_grouped_fused(dp, live, acc, cls)

        print(json.dumps({"tree": label, "case": name,
                          "rows": cls.shape[0], "T": cls.shape[1],
                          "groups": dp.follow.shape[0],
                          "states": dp.n_states, "classes": dp.n_classes,
                          "equal": bool(torch.equal(k1(), k4())),
                          "matched": int(k1().sum()),
                          "k1_kernels_ms": kernels_ms(torch, k1, reps),
                          "k4_kernels_ms": kernels_ms(torch, k4, reps),
                          "wrapper_ms": {"k1": cuda_ms(torch, k1, reps),
                                         "k4": cuda_ms(torch, k4, reps)}}),
              flush=True)
        del cls
    pats = chip_smoke.make_patterns(64) + [watch_list(700)]
    eng = GpuEngineFilter(pats, device=dev)
    dp, live, acc = eng._grouped, eng._g_live, eng._g_acc
    G = dp.follow.shape[0]
    r, lens = chip_smoke.k1024_rows(np, synthetic_line, 131072, 128,
                                    SEED + 4)
    batch, lens = torch.from_numpy(r).to(dev), torch.from_numpy(lens).to(dev)
    cls = nfa.classify_chunk(dp, batch, lens, True, True)
    words = sweep.sweep_group_bits(eng._sweep_tables, batch, lens)
    pairs, n_pairs, _ = nk.gate_pairs(words, G)

    def launch():
        return nk.launch_gated(dp, live, acc, cls, pairs, n_pairs)

    def k3():
        return nk.match_cls_grouped_gated(dp, live, acc, cls, words)[0]

    print(json.dumps({"tree": label, "case": "k64_watch700_sweep",
                      "rows": cls.shape[0], "T": cls.shape[1], "groups": G,
                      "states": dp.n_states,
                      "pairs": int(unpack_bits(words.long(), G).sum()),
                      "equal": bool(torch.equal(
                          k3(), nk.match_cls_grouped(dp, live, acc, cls))),
                      "matched": int(k3().sum()),
                      "kernels_ms": kernels_ms(torch, launch, 3),
                      "launch_ms": cuda_ms(torch, launch, 3),
                      "wrapper_ms": cuda_ms(torch, k3, 3)}), flush=True)
    del eng, cls, batch, words, pairs
    k2g_past160(np, torch, compile_patterns, nfa, nk, dev, label, rng)


def k2g_past160(np, torch, compile_patterns, nfa, nk, dev, label: str,
                rng, B: int = 8, n_chunks: int = 4, L: int = 4096) -> None:
    """K2g on the 32 patterns and the 700-pod list (where the tree's K2g
    takes 176 words) and ``chunk_nfa_wide`` on their union, over the
    same B x L chunks, each chunk timed by CUDA events after one
    untimed launch of each."""
    import chip_smoke

    pats = chip_smoke.PATTERNS + [watch_list(700)]
    gp, live, acc = nfa.compile_grouped(pats, device=dev)
    union = compile_patterns(pats)
    up = nfa.pack_program(nfa.augment(union), device=dev)
    needles = [b"pod=pod-0001", b"pod=pod-1399", b"pod=pod-0641",
               b"pod=pod-0642"] + chip_smoke.NEEDLES
    r, lens = chip_smoke.long_rows(np, rng, B, L, (n_chunks - 1) * L + 1,
                                   n_chunks * L, needles)
    rows_d, lens_d = torch.from_numpy(r).to(dev), torch.from_numpy(lens).to(dev)
    grouped = hasattr(nk, "GROUPED_CHUNK_SMEM")  # else the tree refuses it
    vg = nk.initial_state_grouped(gp, live, B)
    vu = nk.initial_state(up, union.n_states, B)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed(fn):
        torch.cuda.synchronize()
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        return out, ev[0].elapsed_time(ev[1])

    # One untimed launch of each kernel first (a program's tables are
    # built at its first call), so that every timed chunk is warm.
    chunk = rows_d[:, :L].contiguous()
    nk.match_chunk_cls(up, union.n_states + 1, nfa.classify_chunk(
        up, chunk, lens_d, True, False), vu, False)
    if grouped:
        nk.match_chunk_cls_grouped(gp, live, acc, nfa.classify_chunk(
            gp, chunk, lens_d, True, False), vg, False)
    k2g_ms, wide_ms, equal = [], [], True
    for k in range(n_chunks):
        final = k == n_chunks - 1
        chunk = rows_d[:, k * L:(k + 1) * L].contiguous()
        cu = nfa.classify_chunk(up, chunk, lens_d - k * L, k == 0, final)
        (vu, mu), ms = timed(lambda: nk.match_chunk_cls(
            up, union.n_states + 1, cu, vu, final))
        wide_ms.append(ms)
        if grouped:
            cg = nfa.classify_chunk(gp, chunk, lens_d - k * L, k == 0, final)
            (vg, mg), ms = timed(lambda: nk.match_chunk_cls_grouped(
                gp, live, acc, cg, vg, final))
            k2g_ms.append(ms)
            equal = equal and bool(torch.equal(mg, mu))
    print(json.dumps({"tree": label, "case": "k2g_watch700_8x4096",
                      "lines": B, "chunks": n_chunks,
                      "groups": gp.follow.shape[0], "states": gp.n_states,
                      "union_states": up.n_states, "matched": int(mu.sum()),
                      "chunk_nfa_wide_ms": wide_ms,
                      "k2g_ms": k2g_ms or None,
                      "equal": equal if grouped else None}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
