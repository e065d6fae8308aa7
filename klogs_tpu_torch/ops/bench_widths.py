"""Time the NFA kernels at program widths off the main path.

The register kernels are built for 4, 8, 16 and 32 state words (S = 128,
256, 512, 1024); a program of another width up to 32 words runs padded
to the next of them. This script times both kernels on union programs
of S = 256, 384, 512 and 640 states, so a tree that pads can be held
against one built for each width:

    python3 klogs_tpu_torch/ops/bench_widths.py [--tree DIR] [--label L]

``--tree`` is the root of the checkout whose ``klogs_tpu_torch`` is
timed (default: the one holding this file). It needs a CUDA device and
nvcc, and prints one JSON line per (kernel, width).
"""

import argparse
import json
import os
import sys

SEED = 20261016
WIDTHS = (256, 384, 512, 640)
K1_ROWS, K1_WIDTH = 16384, 256  # a CLI-sized batch at the 256-byte bucket
K2_LINES, K2_CHUNK = 1024, 4096  # one 4096-byte chunk of 1024 long lines


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
        ms = cuda_ms(torch, lambda: nk.match_chunk_cls(
            prog, union.n_states + 1, cls, v0, False), 5)
        print(json.dumps({"tree": label, "kernel": nk.CHUNK,
                          "states": prog.n_states, "lines": K2_LINES,
                          "T": cls.shape[1], "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
