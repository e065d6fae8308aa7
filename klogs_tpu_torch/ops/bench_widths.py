"""Time the NFA kernels at program widths off the main path.

The register kernels are built for 4, 8, 16 and 32 state words (S = 128,
256, 512, 1024); a program of another width up to 32 words runs padded
to the next of them. This script times both kernels on union programs
of S = 256, 384, 512 and 640 states, so a tree that pads can be held
against one built for each width. K2 runs one 4096-byte chunk of 1024
lines, and of 8 lines (the size of the long-line batches the CLI
hands it; rows without the needle). Then K2 runs the 32-pattern union
of ``chip_smoke.PATTERNS`` (400 states, run at 512) on one mid-line
4096-byte chunk of 8 and of 1024 lines, printable and random bytes,
needles in every third row, held against its plain version:

    python3 klogs_tpu_torch/ops/bench_widths.py [--tree DIR] [--label L]

``--tree`` is the root of the checkout whose ``klogs_tpu_torch`` is
timed (default: the one holding this file). Two trees are compared on
one card by running the script once per tree, in turns (``--tree
dist/prev`` for an unpacked ``git archive`` of the parent). It needs a
CUDA device and nvcc, and prints one JSON line per (kernel, width,
lines).
"""

import argparse
import json
import os
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
    for S in WIDTHS:
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
    k2_bench32(np, torch, compile_patterns, nfa, nk, dev, label)
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


if __name__ == "__main__":
    sys.exit(main())
