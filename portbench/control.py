"""The control of the check, at a cell's own size.

    python3 -m portbench.control --workload CELL --seeds N [N ...]

The control is the reference with one of the configuration's guarantees
broken (its ``control`` entry), put in the program's place: it judges
the frames a run of the cell checks (every collector's pool frames, one
send of each), and its verdicts are held to the reference's as a run
holds the program's. It prints one JSON line a seed: the mismatched
lines (a run's limit is 0, so any number above it fails the control),
the lines judged and the lines each side kept. It needs no card.
"""

import argparse
import json
import os
import time

from portbench import check, spec


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    gen = spec.generator(cell.bench_dir, cell.mix["kind"])
    for seed in args.seeds:
        t = time.monotonic()
        out = check.control(cell, gen, seed,
                            workers=min(8, os.cpu_count() or 1))
        out.update(workload=cell.name, seed=seed,
                   control=cell.config["control"]["kind"],
                   seconds=time.monotonic() - t)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
