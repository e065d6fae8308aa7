"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cell's cards. The
system under test is filterd (``klogs_tpu_torch.service.server``
``FilterServer``) serving the cell's configuration on ``cuda:0`` in this
process, started as ``serve()`` starts it, with its metrics registry on
an ephemeral port. The load is ``collectors`` processes
(``portbench/collector.py``) of ``flows_per_collector`` closed-loop
flows each, reaching it through ``RemoteFilterClient.match_framed``,
kept on a quarter of the host's CPUs apart from the server's
(``split_cpus``), as collectors on other nodes would be.

Set-up (``setup_s``: the harness's first statement to the first timed
send) is the imports, CUDA, the kernels' load (or their nvcc build, into
``klogs_tpu_torch/ops/build`` inside the checkout), the engine's
construction, the server's start, the collectors' pools and their
warm-up, which sends every pool frame of every collector. The window then
lasts ``--seconds``; every RPC in flight at its close is awaited, the
server stops, and the verdicts are checked (``check.py``).

It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted`` and ``failed`` (lines), ``metrics`` (the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read by ``metrics/<name>.py`` from the program's spans and counters and
``torch.profiler``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``: each number compared beside its limit, also the last
lines of standard error. Without a card, with fewer cards than the cell
asks for, or with ``jax``, ``jaxlib``, ``flax`` or ``klogs_tpu`` loaded
once the window has closed, it exits non-zero and prints no result.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from portbench import check, spec, tracing  # noqa: E402
from portbench.peaks import peaks  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "klogs_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def forbidden_modules() -> "list[str]":
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole (``klogs_tpu_torch`` is not ``klogs_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> "str | None":
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


class Collectors:
    """The load generator's processes, started before the server so they
    build their pools while it compiles."""

    def __init__(self, cell, seed: int, out_dir: str,
                 cpus: "list[int] | None" = None):
        self.cell, self.seed, self.out_dir = cell, seed, out_dir
        self.cpus = cpus
        self.procs: "list[asyncio.subprocess.Process]" = []

    async def start(self) -> None:
        for c in range(self.cell.mix["collectors"]):
            job = {"cell": self.cell.name, "root": self.cell.root,
                   "bench_dir": self.cell.bench_dir, "seed": self.seed,
                   "collector": c, "out_dir": self.out_dir,
                   "cpus": self.cpus}
            self.procs.append(await asyncio.create_subprocess_exec(
                sys.executable, "-m", "portbench.collector", json.dumps(job),
                stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))))

    async def expect(self, word: str, timeout: float) -> None:
        for c, p in enumerate(self.procs):
            try:
                line = await asyncio.wait_for(p.stdout.readline(), timeout)
            except asyncio.TimeoutError:
                raise RunError(f"collector {c}: no {word!r} in {timeout} s")
            if line.decode().strip() != word:
                raise RunError(f"collector {c}: expected {word!r}, got "
                               f"{line!r} (exit code {p.returncode})")

    def tell(self, line: str) -> None:
        for p in self.procs:
            p.stdin.write((line + "\n").encode())

    def results(self) -> "list[dict]":
        out = []
        for c in range(len(self.procs)):
            with open(os.path.join(self.out_dir, f"collector{c}.json")) as f:
                res = json.load(f)
            res["verdicts"] = np.load(os.path.join(self.out_dir,
                                                   f"collector{c}.npy"))
            out.append(res)
        return out

    async def stop(self) -> None:
        for p in self.procs:
            if p.returncode is None:
                try:
                    await asyncio.wait_for(p.wait(), 30)
                except asyncio.TimeoutError:
                    p.kill()
                    await p.wait()


def window_numbers(results: "list[dict]", n: int, t0: float, t1: float,
                   seconds: float) -> dict:
    """The end-to-end numbers of the window from the collectors' records:
    RPCs sent in [t0, t1) are attempted; those whose verdicts came in
    [t0, t1] count toward the rate and the tail."""
    done_ms, done_lines, attempted, failed = [], 0, 0, 0
    for res in results:
        for _, _, t_send, t_done, ok, _ in res["records"][res["warm"]:]:
            if t0 <= t_send < t1:
                attempted += n
                if not ok:
                    failed += n
            if ok and t0 <= t_done <= t1:
                done_lines += n
                done_ms.append((t_done - t_send) * 1e3)
    p95 = (statistics.quantiles(done_ms, n=20, method="inclusive")[18]
           if len(done_ms) >= 2 else float("nan"))
    return {"lines_per_s": done_lines / seconds, "frame_p95_ms": p95,
            "rpcs": len(done_ms), "attempted": attempted, "failed": failed}


def split_cpus() -> "list[int] | None":
    """Keep the load generator off the server's cores, as collectors on
    other nodes are: this process (and every thread and process it starts
    after) keeps three quarters of the CPUs it may use, and the
    collectors get the rest. None with fewer than 4 CPUs."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 4:
        return None
    k = len(cpus) // 4
    os.sched_setaffinity(0, cpus[:-k])
    return cpus[-k:]


async def run_cell(cell, seed: int, seconds: float, trace: bool,
                   device: str = "cuda",
                   collector_cpus: "list[int] | None" = None) -> dict:
    import torch

    from klogs_tpu_torch.obs import trace as obs_trace
    from klogs_tpu_torch.service.server import FilterServer

    # The deployment's settings of the server (a thousand-rule set raises
    # the compiler's cap on pattern positions, as its operator would).
    os.environ.update(cell.config.get("env", {}))
    gen = spec.generator(cell.bench_dir, cell.mix["kind"])
    n = cell.mix["frame_lines"]
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    collectors = Collectors(cell, seed, out_dir, collector_cpus)
    server = None
    try:
        await collectors.start()
        server = FilterServer(cell.config["patterns"], "cuda",
                              host="127.0.0.1", port=0, metrics_port=0,
                              ignore_case=cell.config.get("ignore_case",
                                                          False),
                              device=device)
        port = await server.start()
        await collectors.expect("pooled", 300)
        collectors.tell(f"connect 127.0.0.1:{port}")
        await collectors.expect("ready", 600)
        spans: "list[dict]" = []
        prof = None
        if trace:
            # The server's finished spans, kept in memory.
            obs_trace.TRACER.add_sink(spans.append)
            obs_trace.TRACER.configure(sample=1.0)
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA]
                           if device != "cpu" else [ProfilerActivity.CPU])
            prof.start()
        before = tracing.read_counters(server.registry)
        t0 = time.monotonic() + 0.05
        t1 = t0 + seconds
        u0 = time.time() + (t0 - time.monotonic())
        collectors.tell(f"go {t0!r} {t1!r}")
        setup_s = t0 - T_START
        await asyncio.sleep(max(0.0, t1 - time.monotonic()))
        after = tracing.read_counters(server.registry)
        u1 = u0 + seconds
        tr = None
        if trace:
            obs_trace.TRACER.configure(sample=0.0)
            prof.stop()
            obs_trace.TRACER.remove_sink(spans.append)
            tr = tracing.Trace(
                t0=u0, t1=u1, spans=spans,
                counters=tracing.counter_delta(before, after),
                pattern_bytes=sum(len(p.encode())
                                  for p in cell.config["patterns"]),
                has_device_trace=device != "cpu")
            if tr.has_device_trace:
                tr.device = tracing.device_events(prof, u0, u1)
        await collectors.expect("done", 300)
        peak = (torch.cuda.max_memory_allocated(torch.device(device))
                if device != "cpu" else 0)
        await server.stop()
        server = None
        await collectors.stop()
        results = collectors.results()
    finally:
        if server is not None:
            await server.stop()
        for p in collectors.procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    numbers = window_numbers(results, n, t0, t1, seconds)
    numbers["setup_s"] = setup_s
    t_check = time.monotonic()
    verdict = check.compare(cell, gen, seed, results,
                            workers=min(8, os.cpu_count() or 1))
    verdict["reference_s"] = time.monotonic() - t_check
    return {"numbers": numbers, "check": verdict, "trace": tr,
            "memory_peak_bytes": int(peak)}


def result_line(cell, out: dict, trace: bool, device: str) -> dict:
    import torch

    numbers, verdict, tr = out["numbers"], out["check"], out["trace"]
    kind = (torch.cuda.get_device_name(0) if device != "cpu"
            else "cpu")
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"],
           "power_limit": power_limit() if device != "cpu" else None}
    metrics = {}
    line = {}
    if trace:
        tr.peaks = peaks(kind)
        for m in cell.per_layer:
            value = spec.reader(cell.bench_dir, m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        line["breakdown"] = tracing.breakdown(tr)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": numbers[m["name"]],
                                  "unit": m["unit"]}
    correct = verdict["mismatched_lines"] == 0 and verdict["lost_lines"] == 0
    return {"correct": correct, "attempted": numbers["attempted"],
            "failed": numbers["failed"], "metrics": metrics, "device": dev,
            **line,
            "check": {"mismatched_lines": {
                          "value": verdict["mismatched_lines"], "limit": 0},
                      "lost_lines": {"value": verdict["lost_lines"],
                                     "limit": 0},
                      "checked_lines": verdict["checked_lines"],
                      "reference_kept": verdict["reference_kept"],
                      "reference_judged": verdict["reference_judged"],
                      "reference_s": verdict["reference_s"],
                      "rpcs_in_window": numbers["rpcs"]}}


def main(argv: "list[str] | None" = None, root: str = spec.ROOT,
         bench_dir: str = spec.BENCH_DIR, device: "str | None" = None) -> int:
    """``device`` None looks for the cell's cards and runs on ``cuda``;
    a test passes ``"cpu"`` (the kernels' plain versions)."""
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, root=root, bench_dir=bench_dir)
    collector_cpus = None
    if device is None:
        import torch

        if not torch.cuda.is_available():
            print("portbench: no CUDA device; the benchmark never runs on "
                  "the CPU", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda:0"
        collector_cpus = split_cpus()
    out = asyncio.run(run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device,
                               collector_cpus=collector_cpus))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace), device)
    for name, v in line["check"].items():
        if isinstance(v, dict):
            print(f"check {name} {v['value']} limit {v['limit']}",
                  file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # The gRPC and CUDA runtimes may print at interpreter teardown: end
    # here, so the result stays the last line of standard output.
    os._exit(code)
