"""Sweep the pipeline's operating point on the card: the coalescer's
group size against the in-flight depth, through the service layer that
the ``KLOGS_TUNE=auto`` controller tunes.

    python3 klogs_tpu_torch/ops/bench_operating_point.py [--out PATH]

One ``AsyncFilterService(GpuEngineFilter(chip_smoke.PATTERNS))`` takes
the ``cli`` cell's shape of traffic: 256 concurrent callers, each calling
``match_framed`` with its own frame of 4000 FakeCluster lines again and
again until the point has passed its lines: ``--lines`` (2,000,000) in
the first turn, a quarter more in each later one. The grid is
``coalesce_lines`` x ``max_in_flight`` (``--batches``, ``--flights``),
moved between points by ``apply_tuning`` as the controller moves it;
each point runs ``--repeats`` times (3), the grid in turns, and keeps
its median lines/s. Every run (``samples``) is fitted to ``time = c +
a*dispatches + b*lines`` (``fit_runs``, after the JAX package's
``tools/bench_operating_point.py``; the turns' different line counts
tell ``c`` from ``b``): ``a`` is the cost of one device batch, ``1/b``
the engine-only lines/s.

It appends one record to ``--out`` (default: ``operating_point.json``
beside this file, the controller's envelope and ``FleetCapacity``'s
operating point): the date, the card's name and power limit from
``nvidia-smi``, torch's version, the pattern count, the mean line bytes,
the callers and frame size, the runs (``batch`` = coalesce_lines,
``n_flight`` = max_in_flight, ``lps``, ``lines_per_batch``, ``lines``),
every turn's run of each point (``samples``) and the fit. It needs a CUDA device and nvcc; about 2 minutes.
"""

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

def fit_runs(runs: "list[dict]") -> dict:
    """Least-squares fit of ``time = c + a*dispatches + b*lines`` over
    the runs (each run's time is ``lines / lps``, its dispatches ``lines
    / lines_per_batch``). ``c`` is the fixed cost of a point (the ramp
    and the drain), ``a`` a device batch's own cost, ``1/b`` the rate
    with batches free: the engine-only lines/s."""
    import numpy as np

    A = np.array([[1.0, r["lines"] / r["lines_per_batch"], r["lines"]]
                  for r in runs], dtype=np.float64)
    y = np.array([r["lines"] / r["lps"] for r in runs])
    (c, a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ np.array([c, a, b])
    return {"model": "time = c + a*dispatches + b*lines",
            "per_measurement_ms": round(c * 1e3, 1),
            "per_dispatch_ms": round(a * 1e3, 3),
            "engine_only_lps": round(1.0 / b, 1) if b > 0 else None,
            "max_residual_pct": round(
                float(np.max(np.abs(pred - y) / y)) * 100, 1)}


def card() -> "tuple[str, str]":
    """(name, power limit) as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name, _, limit = out.partition(",")
    return name.strip(), limit.strip()


def make_frames(np, FakeCluster, frame_base, callers: int, frame_lines: int):
    """One frame a caller: a pod's FakeCluster lines, newlines kept."""
    fc = FakeCluster.synthetic(n_pods=callers, n_containers=1,
                               lines_per_container=frame_lines,
                               clock=lambda: 1_700_000_000.0)
    pods = fc.namespaces["default"]
    frames = []
    for name in sorted(pods):
        lines = [ln for _, ln in pods[name].containers["c0"].lines]
        frames.append(frame_base(lines, strip_nl=False)[:2])
    return frames


async def drive(svc, frames, target: int) -> "tuple[int, float, int]":
    """Every caller sends its frame until ``target`` lines have gone
    through: (lines, seconds, device batches)."""
    done = [0]
    batches0 = svc.batches_dispatched

    async def caller(payload, offsets):
        n = len(offsets) - 1
        while done[0] < target:
            done[0] += n
            await svc.match_framed(payload, offsets)

    t0 = time.perf_counter()
    await asyncio.gather(*[caller(p, o) for p, o in frames])
    seconds = time.perf_counter() - t0
    return done[0], seconds, svc.batches_dispatched - batches0


async def settle(svc, coalesce_lines: int, max_in_flight: int) -> None:
    """Move the service to a point, and wait until a decrease's permits
    have been absorbed (the pipeline is idle between points)."""
    svc.apply_tuning(coalesce_lines=coalesce_lines,
                     max_in_flight=max_in_flight)
    for _ in range(1000):
        sem = svc._sem
        if sem is None or sem._value == svc.max_in_flight:
            return
        await asyncio.sleep(0.001)
    raise RuntimeError("in-flight permits did not settle between points")


async def sweep(svc, frames, batches, flights, repeats: int, target: int):
    await settle(svc, batches[0], flights[0])
    await drive(svc, frames, target // 4)  # build, load, warm
    seen: "dict[tuple[int, int], list]" = {}
    samples = []
    for rep in range(repeats):
        for b in batches:
            for nf in flights:
                await settle(svc, b, nf)
                lines, seconds, disp = await drive(
                    svc, frames, target + rep * target // 4)
                run = {"batch": b, "n_flight": nf,
                       "lps": round(lines / seconds, 1),
                       "lines_per_batch": round(lines / disp, 1),
                       "lines": lines}
                seen.setdefault((b, nf), []).append(run)
                samples.append(run)
                print(json.dumps({"repeat": rep, "dispatches": disp, **run}),
                      flush=True)
    # Each point's median run by lines/s.
    runs = [sorted(got, key=lambda r: r["lps"])[len(got) // 2]
            for got in seen.values()]
    return runs, samples


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(here,
                                                  "operating_point.json"))
    ap.add_argument("--batches", default="2048,8192,32768,131072")
    ap.add_argument("--flights", default="4,8,16,32,64")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--lines", type=int, default=2_000_000)
    ap.add_argument("--callers", type=int, default=256)
    ap.add_argument("--frame-lines", type=int, default=4000)
    ap.add_argument("--date", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(here)))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_operating_point: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from klogs_tpu_torch.cluster.fake import FakeCluster
    from klogs_tpu_torch.filters.async_service import AsyncFilterService
    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter

    batches = [int(x) for x in args.batches.split(",")]
    flights = [int(x) for x in args.flights.split(",")]
    name, limit = card()
    print(json.dumps({"card": name, "power_limit": limit,
                      "torch": torch.__version__}), flush=True)
    frames = make_frames(np, FakeCluster, frame_lines, args.callers,
                         args.frame_lines)
    n_lines = sum(len(o) - 1 for _, o in frames)
    line_bytes = sum(len(p) for p, _ in frames) / n_lines
    svc = AsyncFilterService(GpuEngineFilter(cs.PATTERNS,
                                             device=torch.device("cuda", 0)))

    async def go():
        try:
            return await sweep(svc, frames, batches, flights, args.repeats,
                               args.lines)
        finally:
            await svc.aclose()

    t0 = time.perf_counter()
    runs, samples = asyncio.run(go())
    fit = fit_runs(samples)
    record = {
        "date": args.date or time.strftime("%Y-%m-%d"),
        "device": name,
        "power_limit": limit,
        "torch": torch.__version__,
        "n_patterns": len(cs.PATTERNS),
        "line_bytes": round(line_bytes, 1),
        "callers": args.callers,
        "frame_lines": args.frame_lines,
        "lines_per_point": args.lines,
        "repeats": args.repeats,
        "script": "klogs_tpu_torch/ops/bench_operating_point.py",
        "runs": runs,
        "samples": samples,
        "dispatch_fit": fit,
    }
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing.append(record)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
        f.write("\n")
    print(json.dumps({"fit": fit, "best_lps": max(r["lps"] for r in runs),
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
