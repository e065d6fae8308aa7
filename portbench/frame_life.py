"""What a traced window holds beyond its per-layer metrics, for the card's
own spans (``card.*``, by CUDA events on the host's clock):

    python3 -m portbench.frame_life --workload CELL --seed N --seconds S
    python3 -m portbench.frame_life --drift S

Each prints one JSON line, also written under ``--out DIR`` when given.

The first runs one cell's window as ``run.py --trace 1`` runs it and
prints one JSON line: the cell's per-layer metrics; ``held``, the share
of ``torch.profiler``'s kernel time between the first ``card.batch``
span's start and the last one's end that lies inside ``card.batch``
spans (batches dispatched before the window opened carry no span, and
those fetched after it closed none that the window kept);
``offset_us``, the quartiles over the window's batches of the first
host-to-device copy ``torch.profiler`` saw after a ``card.batch`` start
less that start (the card clock's anchor against the profiler's clock);
and ``life_ms``, a frame's mean life by Little's law (flows x lines a
frame / lines a second) beside the readings it splits into.

``--no-profiler`` runs the window without ``torch.profiler`` (its device
trace reads empty: the device metrics and ``held`` are left out), so the
host's readings are taken without the profiler's cost on every launch.

``--drift`` anchors the card's clock (``filters/gpu.py`` ``CardClock``),
then once a second for S seconds, the first half with the card idle and
the second with its default stream kept busy, records a fresh anchor
event and prints how far the host's time of its record lies from the
first anchor's reading of it (chained a second at a time, in float64),
and how long the record took to complete.
"""

import argparse
import asyncio
import json
import os
import statistics
import sys
import threading
import time

from portbench import run, spec


def held_share(tr) -> "float | None":
    batches = sorted((s["start_unix"], s["start_unix"] + s["duration_s"])
                     for s in tr.spans if s["name"] == "card.batch"
                     and tr.t0 <= s["start_unix"] < tr.t1)
    if not batches:
        return None
    lo, hi = batches[0][0], batches[-1][1]
    total = inside = 0.0
    j = 0
    for a, b in sorted((a, b) for _, _, a, b in tr.kernels()):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        total += b - a
        while j < len(batches) and batches[j][1] <= a:
            j += 1
        k = j
        while k < len(batches) and batches[k][0] < b:
            inside += max(0.0, min(b, batches[k][1]) - max(a, batches[k][0]))
            k += 1
    return inside / total if total else None


def copy_offsets_us(tr) -> "list[float]":
    """A batch's staging copy (the longest host-to-device copy starting
    within 1 ms of its ``card.batch`` start) less that start."""
    copies = sorted((a, b - a) for kind, name, a, b in tr.device
                    if kind == "memcpy" and "HtoD" in name)
    out = []
    i = 0
    for s in sorted(tr.spans_named("card.batch"),
                    key=lambda s: s["start_unix"]):
        start = s["start_unix"]
        while i < len(copies) and copies[i][0] < start - 1e-3:
            i += 1
        near = [c for c in copies[i:i + 64] if c[0] < start + 1e-3]
        if near:
            out.append((max(near, key=lambda c: c[1])[0] - start) * 1e6)
    return out


def per_rpc_ms(tr) -> "dict[str, float] | None":
    """Mean parts of a sampled MatchFramed RPC whose trace holds one
    ``card.batch`` (a group of one frame): ``receive``; from
    ``rpc.server``'s start to its group's ``coalescer.dispatch``; from
    there to the card reaching the batch; the card; from the card's end
    to ``rpc.server``'s end. The last four partition ``rpc.server``."""
    by_trace: "dict[str, dict[str, list]]" = {}
    for s in tr.spans:
        if s["name"] in ("rpc.server", "rpc.receive", "coalescer.dispatch",
                         "card.batch"):
            by_trace.setdefault(s["trace_id"], {}).setdefault(
                s["name"], []).append(s)
    rows = []
    for t in by_trace.values():
        if any(len(t.get(k, ())) != 1 for k in (
                "rpc.server", "rpc.receive", "coalescer.dispatch",
                "card.batch")):
            continue
        srv, rcv = t["rpc.server"][0], t["rpc.receive"][0]
        grp, card = t["coalescer.dispatch"][0], t["card.batch"][0]
        if not tr.t0 <= srv["start_unix"] < tr.t1:
            continue
        s0 = srv["start_unix"]
        s1 = s0 + srv["duration_s"]
        c0 = card["start_unix"]
        c1 = c0 + card["duration_s"]
        rows.append({"receive": rcv["duration_s"],
                     "to_dispatch": grp["start_unix"] - s0,
                     "to_card": c0 - grp["start_unix"],
                     "card": c1 - c0, "after_card": s1 - c1,
                     "server": srv["duration_s"]})
    if not rows:
        return None
    out = {k: sum(r[k] for r in rows) / len(rows) * 1e3 for k in rows[0]}
    out["rpcs"] = len(rows)
    return out


def quartiles(xs: "list[float]") -> "list[float] | None":
    if len(xs) < 2:
        return None
    q = statistics.quantiles(xs, n=4)
    return [min(xs), q[0], q[1], q[2], max(xs)]


class _NoProfiler:
    """``torch.profiler.profile``'s stand-in for ``--no-profiler``."""

    def __init__(self, *args, **kwargs):
        events = type("Events", (), {"events": staticmethod(lambda: [])})
        self.profiler = type("Profiler", (), {"kineto_results": events})

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


DEVICE_METRICS = ("kernel_ms_per_mline", "kernels_roofline",
                  "device_idle_pct")


def cell_main(args) -> int:
    import torch
    import torch.profiler

    if args.no_profiler:
        torch.profiler.profile = _NoProfiler
    cell = spec.load_cell(args.workload)
    out = asyncio.run(run.run_cell(cell, args.seed, args.seconds, True,
                                   "cuda:0",
                                   collector_cpus=run.split_cpus()))
    tr = out["trace"]
    line = run.result_line(cell, out, True, "cuda:0")
    metrics = {k: v["value"] for k, v in line["metrics"].items()
               if not (args.no_profiler and k in DEVICE_METRICS)}
    numbers = out["numbers"]
    flows = cell.mix["collectors"] * cell.mix["flows_per_collector"]
    rate = numbers["lines_per_s"]
    offsets = copy_offsets_us(tr)
    doc = {
        "cell": cell.name, "seed": args.seed,
        "card": torch.cuda.get_device_name(0),
        "power_limit": run.power_limit(),
        "correct": line["correct"], "lines_per_s": rate,
        "frame_p95_ms": numbers["frame_p95_ms"],
        "metrics": metrics,
        "profiler": not args.no_profiler,
        "fetch_workers": os.environ.get("KLOGS_FETCH_WORKERS"),
        "held": None if args.no_profiler else held_share(tr),
        "offset_us": quartiles(offsets), "offset_n": len(offsets),
        "life_ms": {
            "little": flows * cell.mix["frame_lines"] / rate * 1e3
            if rate else None,
            "rpc_server_p50": metrics.get("rpc_server_ms_p50"),
            "rpc_receive": metrics.get("rpc_receive_ms"),
            "coalescer_wait": metrics.get("coalescer_wait_ms"),
            "engine_host": metrics.get("engine_host_ms_per_batch"),
            "card_queue": metrics.get("card_queue_ms"),
            "card": metrics.get("card_ms_per_batch"),
        },
        "per_rpc_ms": per_rpc_ms(tr),
        "batches": len(tr.spans_named("card.batch")),
        "breakdown": line["breakdown"],
    }
    save(args.out, f"frame_life_{cell.name}_{args.seed}"
         f"{'_noprof' if args.no_profiler else ''}.json", doc)
    return 0


def save(out_dir: "str | None", name: str, doc: dict) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc))


def drift_main(seconds: int, out_dir: "str | None") -> int:
    import torch

    from klogs_tpu_torch.filters.gpu import anchor_card_clock, card_clock

    dev = torch.device("cuda", 0)
    anchor_card_clock(dev)
    clock = card_clock(dev)
    prev, unix0, _ = clock.anchor()
    prev.synchronize()
    predicted = unix0
    busy = threading.Event()
    stop = threading.Event()

    def load() -> None:
        # The default stream kept busy with spinning kernels.
        while not stop.is_set():
            if busy.is_set():
                torch.cuda._sleep(50_000_000)
                torch.cuda.current_stream(dev).synchronize()
            else:
                time.sleep(0.01)

    worker = threading.Thread(target=load, daemon=True)
    worker.start()
    rows = []
    try:
        for i in range(1, seconds + 1):
            if i > seconds // 2:
                busy.set()
            time.sleep(1.0)
            t_call = time.time()
            e, unix, _ = clock.anchor()
            e.synchronize()
            took = time.time() - t_call
            predicted += prev.elapsed_time(e) / 1e3
            prev = e
            rows.append({"s": i, "busy": busy.is_set(),
                         "drift_us": (unix - predicted) * 1e6,
                         "record_us": took * 1e6})
    finally:
        stop.set()
        worker.join()
    doc = {"card": torch.cuda.get_device_name(0),
           "power_limit": run.power_limit(), "rows": rows}
    save(out_dir, "card_clock_drift.json", doc)
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.frame_life")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--drift", type=int, default=0)
    ap.add_argument("--no-profiler", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.drift:
        return drift_main(args.drift, args.out)
    return cell_main(args)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
