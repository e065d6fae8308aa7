"""The port's observability layer against the JAX package's: the metric
inventory, the Prometheus rendering and JSON snapshot of the same
operations, the FilterStats view, the HTTP sidecar (every endpoint, and
a request it cannot parse), and one fake run through both apps with
``--stats-json``, ``--trace-json`` and ``--profile-json``.

Tolerance: counts are exact; times are not compared. In the end-to-end
run these families may differ in value, and nothing else:

- ``klogs_engine_compile_total``: the JAX engine counts new (width, rows)
  geometries (each a jit compile); the port counts kernel libraries
  built or loaded by nvcc, none on the CPU.
- ``klogs_engine_bucket_width_bytes``, ``klogs_engine_payload_bytes_total``
  and ``klogs_engine_pad_bytes_total``: the JAX engine's classify path
  buckets and counts each line with its trailing newline, the port
  without (what the device reads).
- ``klogs_trace_spans_total``: the port's host framing is one
  ``device.frame`` span a batch with a child a width bucket, and its long
  lines' chunk launches are a ``device.kernel`` span; the JAX engine has
  a ``device.frame`` a bucket and no span on its long-line path.
- Every histogram's sum and percentiles, ``klogs_process_*``,
  ``klogs_profile_stage_*``, ``klogs_coalescer_*`` and the
  ``klogs_fanout_backpressure_stalls_total`` counter: times, and what
  the coalescer's timing makes of the batches.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from klogs_tpu import app as jax_app
from klogs_tpu import obs as jax_obs
from klogs_tpu.cli import parse_args as jax_parse_args
from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from klogs_tpu.obs import trace as jax_trace
from klogs_tpu.obs.profiler import PROFILER as JAX_PROFILER
from klogs_tpu_torch import app, cli, obs
from klogs_tpu_torch.cluster.fake import FakeCluster
from klogs_tpu_torch.filters.base import FilterStats
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.obs.profiler import PROFILER, STAGES
import bench


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLOCK = 1_753_800_000.0
# The help texts the port words for itself (the TPU's, or a document's).
REWORDED = {"klogs_engine_compile_total", "klogs_fleet_headroom",
            "klogs_trace_spans_total"}


def _port_own(line: str) -> bool:
    """Whether an exposition line is one of the port's own families'."""
    words = line.split()
    name = words[2] if line.startswith("#") else words[0].split("{")[0]
    return name.startswith(obs.PORT_FAMILIES)


def _render(render, registry) -> str:
    """The exposition with the reworded help lines and the port's own
    families taken out."""
    return "\n".join(ln for ln in render(registry).splitlines()
                     if not any(ln.startswith(f"# HELP {n} ")
                                for n in REWORDED) and not _port_own(ln))


def _snap(snapshot, registry) -> dict:
    return {k: (v if k not in REWORDED else dict(v, help=None))
            for k, v in snapshot(registry).items()
            if k not in obs.PORT_FAMILIES}


def read_all(out_dir) -> dict:
    return {f: (out_dir / f).read_bytes() for f in sorted(os.listdir(out_dir))}


@pytest.fixture(autouse=True)
def _clean_obs():
    """Both packages' process-wide tracer and profiler start and end
    clean (the two packages' singletons are separate objects)."""
    for prof, tr in ((PROFILER, trace), (JAX_PROFILER, jax_trace)):
        prof.reset()
        tr.reset(None)
    yield
    for prof, tr in ((PROFILER, trace), (JAX_PROFILER, jax_trace)):
        prof.reset()
        tr.reset(None)


# -- the inventory and the rendering ------------------------------------


def test_inventory_equals_jax():
    """Same family names, types, label names and buckets as JAX's SPECS,
    then the port's own; ``register_all`` instantiates every one."""
    assert list(obs.SPECS) == list(jax_obs.SPECS) + list(obs.PORT_FAMILIES)
    assert len(obs.SPECS) == 95 + 4
    for name in obs.PORT_FAMILIES:
        assert obs.SPECS[name]["help"]
    for name, spec in obs.SPECS.items():
        if name in obs.PORT_FAMILIES:
            continue
        ref = jax_obs.SPECS[name]
        for key in ("type", "labels", "buckets", "bounds"):
            assert spec.get(key) == ref.get(key), (name, key)
        assert spec["help"]
    assert {n for n in jax_obs.SPECS
            if obs.SPECS[n]["help"] != jax_obs.SPECS[n]["help"]} == REWORDED
    r, jr = obs.Registry(), jax_obs.Registry()
    obs.register_all(r)
    jax_obs.register_all(jr)
    shared = [f for f in r.collect() if f.name not in obs.PORT_FAMILIES]
    assert [f.name for f in shared] == [f.name for f in jr.collect()]
    assert [(f.type, f.labelnames) for f in shared] == \
        [(f.type, f.labelnames) for f in jr.collect()]
    assert {f.name for f in r.collect()} - {f.name for f in shared} == set(
        obs.PORT_FAMILIES)


def _drive(registry, seed: int) -> None:
    """A seeded mix of operations on a registry's families."""
    rng = np.random.default_rng(seed)
    obs_like = registry
    for _ in range(200):
        op = int(rng.integers(6))
        if op == 0:
            obs_like.family("klogs_sink_lines_total").inc(int(rng.integers(1, 9000)))
        elif op == 1:
            obs_like.family("klogs_coalescer_queue_depth").set(int(rng.integers(0, 40)))
        elif op == 2:
            obs_like.family("klogs_sink_batch_latency_seconds").observe(
                float(rng.choice([0.0004, 0.003, 0.02, 0.3, 4.0, 11.0])))
        elif op == 3:
            obs_like.family("klogs_fanout_stream_bytes_total").labels(
                pod=f"pod-{int(rng.integers(4)):04d}",
                container='c"0\\\n').inc(int(rng.integers(1, 1 << 20)))
        elif op == 4:
            obs_like.family("klogs_engine_bucket_width_bytes").observe(
                int(rng.choice([128, 256, 4096, 1 << 20])))
        else:
            obs_like.family("klogs_sweep_lines_total").labels(
                path=str(rng.choice(["device", "host"]))).inc(
                    int(rng.integers(1, 100)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_render_and_snapshot_equal_jax(seed):
    """The same operations on both Registries render to identical
    /metrics text, with and without exemplars' absence, and snapshot to
    the same document."""
    r, jr = obs.Registry(), jax_obs.Registry()
    for reg in (r, jr):
        _drive(reg, seed)
    assert obs.render(r) == jax_obs.render(jr)
    assert obs.snapshot(r) == jax_obs.snapshot(jr)
    obs.register_all(r)
    jax_obs.register_all(jr)
    assert _render(obs.render, r) == _render(jax_obs.render, jr)
    assert _snap(obs.snapshot, r) == _snap(jax_obs.snapshot, jr)


def test_filterstats_is_a_view_over_the_registry():
    """The --stats numbers and the registry are one store, and the same
    records give the JAX FilterStats' numbers."""
    from klogs_tpu.filters.base import FilterStats as JaxFilterStats

    r = obs.Registry()
    s, js = FilterStats(registry=r), JaxFilterStats()
    for st in (s, js):
        st.record_batch(n_lines=100, n_matched=7, n_bytes_in=4000,
                        n_bytes_out=300, latency_s=0.01)
        st.record_batch(n_lines=50, n_matched=3, n_bytes_in=2000,
                        n_bytes_out=90, latency_s=0.03)
        st.record_prefilter(150, 10, 4, 1)
        st.record_sweep("device", 150, 10)
        st.record_deadline_flush()
        st.record_queue_wait(0.002)
        st.record_device_batch(0.004)
        st.record_engine_batch(128, 8, 700)
        st.record_degraded("drop", 5)
    for attr in ("lines_in", "lines_matched", "batches", "bytes_in",
                 "bytes_out", "pf_lines", "pf_candidates", "pf_tiles_total",
                 "pf_tiles_live", "degraded_lines", "has_service_latencies"):
        assert getattr(s, attr) == getattr(js, attr), attr
    for q in (50, 99):
        assert s.percentile_latency_s(q) == js.percentile_latency_s(q)
    assert s.matched_pct() == js.matched_pct()
    assert (s.sweep_batches, s.sweep_lines, s.sweep_candidates) == (1, 150, 10)
    assert s.deadline_flushes == 1
    assert r.family("klogs_sink_lines_total").value == 150
    assert r.family("klogs_engine_pad_bytes_total").value == 128 * 8 - 700
    # The JAX stats also register the sweep's fallback counter; the port
    # has no fallback.
    exp = _snap(jax_obs.snapshot, js.registry)
    del exp["klogs_sweep_fallback_total"]
    assert _snap(obs.snapshot, r) == exp


# -- the sidecar ----------------------------------------------------------


async def _raw(port: int, data: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    return raw


async def _get(port: int, path: str) -> tuple[int, bytes]:
    raw = await _raw(port, f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


@pytest.mark.parametrize("path, status, check", [
    ("/metrics", 200, lambda b: b"klogs_sink_lines_total 5\n" in b
     and b"klogs_process_rss_bytes " in b),
    ("/healthz", 200, lambda b: json.loads(b)["live"] is True),
    ("/readyz", 200, lambda b: json.loads(b)["ready"] is True),
    ("/traces", 200, lambda b: [s["name"] for t in json.loads(b)["traces"]
                                for s in t["spans"]] == ["sink.flush"]),
    ("/profile", 200, lambda b: set(json.loads(b)["samples"])
     == {"probe.one"}),
    ("/nope", 404, lambda b: b"/profile" in b),
], ids=["metrics", "healthz", "readyz", "traces", "profile", "unknown"])
def test_sidecar_endpoint(path, status, check):
    r = obs.Registry()
    obs.register_all(r)
    r.family("klogs_sink_lines_total").inc(5)
    health = obs.Health()
    health.set_ready()
    trace.reset(1.0)
    with trace.TRACER.span("sink.flush", pending=3):
        pass
    PROFILER.enable(1.0)
    PROFILER.add_probe("probe.one", lambda: 1.0)

    async def run():
        srv = obs.MetricsHTTPServer(r, health=health, port=0)
        port = await srv.start()
        try:
            return await _get(port, path)
        finally:
            await srv.stop()

    got_status, body = asyncio.run(run())
    assert got_status == status
    assert check(body), body[:300]


def test_sidecar_health_transitions_and_non_get():
    health = obs.Health()
    alive = {"ok": True}
    health.add_live_check("loop", lambda: alive["ok"])

    async def run():
        srv = obs.MetricsHTTPServer(obs.Registry(), health=health, port=0)
        port = await srv.start()
        try:
            assert (await _get(port, "/readyz"))[0] == 503
            health.set_ready(False)
            health.mark_warm()  # a late warm-up does not undo a drain
            assert (await _get(port, "/readyz"))[0] == 503
            health.set_ready()
            assert (await _get(port, "/readyz"))[0] == 200
            alive["ok"] = False
            status, body = await _get(port, "/healthz")
            assert status == 503 and json.loads(body)["checks"]["loop"] is False
            raw = await _raw(port, b"POST /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
            assert b"405" in raw.split(b"\r\n", 1)[0]
        finally:
            await srv.stop()

    asyncio.run(run())


@pytest.mark.parametrize("garbage", [
    b"GET /metrics HTTP/1.1\r\nX: " + b"a" * 200_000 + b"\r\n\r\n",
    b"G" * 300_000,
    b"\r\n",
    bytes(range(256)) * 600 + b"\r\n\r\n",
], ids=["long_header", "no_newline", "empty_line", "binary"])
def test_sidecar_drops_garbage_quietly_and_keeps_serving(garbage):
    """A request the sidecar cannot parse is dropped quietly: the peer's
    read ends without a reset, no task exception is left unretrieved,
    and the next scrape is served."""
    r = obs.Registry()
    r.counter("t_total").inc(3)
    errors = []

    async def run():
        asyncio.get_running_loop().set_exception_handler(
            lambda loop, ctx: errors.append(ctx))
        srv = obs.MetricsHTTPServer(r, port=0)
        port = await srv.start()
        try:
            for _ in range(2):
                got = await _raw(port, garbage)
                assert b"200 OK" not in got
            status, body = await _get(port, "/metrics")
            assert status == 200 and b"t_total 3" in body
        finally:
            await srv.stop()

    asyncio.run(run())
    assert errors == []


# -- one run through both apps ---------------------------------------------


def _span_names(path: str) -> dict:
    names: dict = {}
    with open(path) as f:
        for line in f:
            doc = json.loads(line)
            names[doc["name"]] = names.get(doc["name"], 0) + 1
    return names


def _obs_run(tmp_path, side: str, args: list, long_line: bytes,
             monkeypatch) -> dict:
    d = tmp_path / side
    d.mkdir()
    argv = ["-n", "default", "-a", "-p", str(d / "out"),
            "--stats-json", str(d / "s.json"),
            "--trace-json", str(d / "t.jsonl"),
            "--profile-json", str(d / "p.jsonl"), *args]
    monkeypatch.setenv("KLOGS_PROFILE_INTERVAL_S", "0.05")
    # The JAX side's settings hold for its run only: the port raises on
    # KLOGS_TPU_KERNEL=interpret.
    with monkeypatch.context() as side_patch:
        if side == "jax":
            # The JAX engine's one-device framed path (the one the port
            # ports), where its device.frame and device.kernel spans are:
            # the Pallas kernels in interpret mode, and one device (the
            # test platform's eight virtual ones would take its mesh
            # path, which has none of them).
            import jax

            side_patch.setenv("KLOGS_TPU_KERNEL", "interpret")
            side_patch.setattr(jax, "device_count", lambda: 1)
            fc = JaxFakeCluster.synthetic(n_pods=3, lines_per_container=120,
                                          clock=lambda: CLOCK)
            run = jax_app.run_async(
                jax_parse_args(argv + ["--backend", "tpu"]), backend=fc)
        else:
            fc = FakeCluster.synthetic(n_pods=3, lines_per_container=120,
                                       clock=lambda: CLOCK)
            run = app.run_async(cli.parse_args(argv), backend=fc,
                                device="cpu")
        fc.namespaces["default"]["pod-0001"].containers["c0"].lines.insert(
            10, (CLOCK - 70, long_line))
        assert asyncio.run(run) == 0
    with open(d / "s.json") as f:
        stats = json.load(f)
    with open(d / "p.jsonl") as f:
        profile = [json.loads(ln) for ln in f]
    return dict(files=read_all(d / "out"), stats=stats,
                spans=_span_names(str(d / "t.jsonl")), profile=profile,
                trace_path=str(d / "t.jsonl"))


# The JAX engine's sweep and group-scan stages (its IndexedFilter) have no
# counterpart in the port yet.
JAX_ONLY_SPANS = {"device.sweep", "device.groupscan"}
EXACT_FAMILIES = (
    "klogs_sink_lines_total", "klogs_sink_lines_matched_total",
    "klogs_sink_bytes_in_total", "klogs_sink_bytes_out_total",
    "klogs_fanout_stream_bytes_total", "klogs_fanout_stream_errors_total",
    "klogs_fanout_active_streams", "klogs_fanout_reconnects_total",
    "klogs_retry_attempts_total", "klogs_faults_injected_total",
    "klogs_build_info",
)


def test_stats_trace_profile_equal_jax(tmp_path, monkeypatch):
    """``--stats-json``/``--trace-json``/``--profile-json`` at K = 32 with
    a line longer than the chunk: the same files, summary counts, family
    names, exact families and span names in both packages; every profile
    line's stages come from ``STAGES``."""
    long_line = b"x" * 6000 + b" panic: tail " + b"y" * 3000 + b"\n"
    args = [a for p in bench.PATTERNS for a in ("--match", p)]
    got = {side: _obs_run(tmp_path, side, args, long_line, monkeypatch)
           for side in ("jax", "torch")}
    t, j = got["torch"], got["jax"]
    assert t["files"] == j["files"]
    assert long_line in t["files"]["pod-0001__c0.log"]
    for key in ("lines_in", "lines_matched"):
        assert t["stats"]["summary"][key] == j["stats"]["summary"][key]
    assert t["stats"]["summary"]["lines_in"] == 361
    assert set(t["stats"]["metrics"]) == set(j["stats"]["metrics"]) | set(
        obs.PORT_FAMILIES)
    for name in EXACT_FAMILIES:
        strip = [{k: v for k, v in s.items()} for s in
                 t["stats"]["metrics"][name]["samples"]]
        assert strip == j["stats"]["metrics"][name]["samples"], name
    assert set(t["spans"]) == set(j["spans"]) - JAX_ONLY_SPANS
    assert {"fanout.read", "sink.flush", "sink.write", "coalescer.dispatch",
            "device.frame", "device.kernel", "device.fetch"} <= set(t["spans"])
    assert t["stats"]["metrics"]["klogs_trace_spans_total"]["samples"][0][
        "value"] == sum(t["spans"].values())
    # Every kept line was written under a sink.write span.
    with open(t["trace_path"]) as f:
        written = sum(json.loads(ln)["attrs"].get("bytes", 0)
                      for ln in f if '"sink.write"' in ln)
    assert written == sum(len(v) for v in t["files"].values())
    assert t["profile"], "no profile line"
    for doc in t["profile"]:
        assert set(doc["stages"]) <= set(STAGES)
        assert set(doc) == {"t", "enabled", "sample", "wall_s", "stages",
                            "samples", "bottleneck"}
    last = t["profile"][-1]
    assert set(last["stages"]) == set(j["profile"][-1]["stages"]) \
        - JAX_ONLY_SPANS
    assert set(last["samples"]) == set(j["profile"][-1]["samples"])
    for stage, v in last["stages"].items():
        assert v["spans"] == t["spans"][stage], stage


def test_second_run_starts_at_zero(tmp_path):
    """The registry is the run's: a second run in one process dumps the
    same counts, not the sum."""
    dumps = []
    for i in range(2):
        fc = FakeCluster.synthetic(n_pods=2, lines_per_container=40,
                                   clock=lambda: CLOCK)
        path = tmp_path / f"s{i}.json"
        opts = cli.parse_args(["-n", "default", "-a", "-p",
                               str(tmp_path / f"o{i}"), "--match", "ERROR",
                               "--stats-json", str(path)])
        assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
        with open(path) as f:
            dumps.append(json.load(f)["summary"])
    assert dumps[0]["lines_in"] == dumps[1]["lines_in"] == 80
    assert dumps[0]["lines_matched"] == dumps[1]["lines_matched"] == 20


def test_metrics_port_serves_during_the_run(tmp_path, monkeypatch):
    """--metrics-port: scrapes of /metrics and /profile taken while the
    follow run's streams are open parse, and show every family and the
    fan-out's open streams."""
    ports = []
    orig_start = obs.MetricsHTTPServer.start

    async def start_and_record(self):
        ports.append(await orig_start(self))
        return ports[-1]

    monkeypatch.setattr(obs.MetricsHTTPServer, "start", start_and_record)
    monkeypatch.setenv("KLOGS_PROFILE_INTERVAL_S", "0.05")
    fc = FakeCluster.synthetic(n_pods=2, lines_per_container=40,
                               clock=lambda: CLOCK)
    opts = cli.parse_args(["-n", "default", "-a", "-f", "-p", str(tmp_path),
                           "--match", "ERROR", "--metrics-port", "0",
                           "--profile-json", str(tmp_path / "p.jsonl")])
    seen = {}

    async def scrape_then_stop(stop):
        for _ in range(500):
            await asyncio.sleep(0.01)
            if ports:
                break
        else:
            raise AssertionError("metrics sidecar never started")
        for _ in range(100):
            seen["metrics"] = await _get(ports[0], "/metrics")
            if b"klogs_sink_lines_total 0\n" not in seen["metrics"][1]:
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.12)  # past a profiler tick
        seen["profile"] = await _get(ports[0], "/profile")
        stop.set()

    async def main():
        stop = asyncio.Event()
        task = asyncio.create_task(scrape_then_stop(stop))
        rc = await app.run_async(opts, backend=fc, stop=stop, device="cpu")
        await task
        return rc

    assert asyncio.run(main()) == 0
    status, body = seen["metrics"]
    assert status == 200
    fams = {ln.split()[2] for ln in body.decode().splitlines()
            if ln.startswith("# TYPE")}
    assert fams == set(obs.SPECS)
    assert b"klogs_fanout_active_streams 2\n" in body
    status, body = seen["profile"]
    doc = json.loads(body)
    assert status == 200 and doc["samples"]["fanout.active_streams"] == 2.0


def test_stats_json_without_a_filter(tmp_path):
    """--stats-json on an unfiltered run dumps the registry (the fan-out's
    families) and no summary, as the JAX app does."""
    fc = FakeCluster.synthetic(n_pods=2, lines_per_container=10,
                               clock=lambda: CLOCK)
    path = tmp_path / "s.json"
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(tmp_path / "o"),
                           "--stats-json", str(path)])
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    with open(path) as f:
        doc = json.load(f)
    assert "summary" not in doc
    samples = doc["metrics"]["klogs_fanout_stream_bytes_total"]["samples"]
    assert sum(s["value"] for s in samples) == sum(
        os.path.getsize(tmp_path / "o" / n) for n in os.listdir(tmp_path / "o"))


# -- the flags, --profile and the tuner --------------------------------------

OBS_FLAGS = [
    ["--metrics-port", "0"], ["--metrics-port", "9100"],
    ["--stats-json", "/tmp/s.json"], ["--trace-json", "t.jsonl"],
    ["--profile-json", "p.jsonl"], ["--profile", "prof"],
    ["--stats", "--stats-json", "s", "--trace-json", "t", "--profile-json",
     "p", "--metrics-port", "1", "--profile", "d"],
]


@pytest.mark.parametrize("argv", OBS_FLAGS, ids=lambda a: " ".join(a))
def test_obs_flags_parse_as_jax(argv):
    got = vars(cli.parse_args(argv + ["-p", "x"]))
    exp = vars(jax_parse_args(argv + ["-p", "x"]))
    assert {k: v for k, v in got.items() if k != "backend"} == {
        k: exp[k] for k in got if k != "backend"}


@pytest.mark.parametrize("argv", [["--metrics-port", "abc"],
                                  ["--metrics-port"], ["--stats-json"]],
                         ids=["not_a_port", "no_port", "no_path"])
def test_obs_flag_errors_equal_jax(argv, capsys):
    from klogs_tpu.cli import main as jax_main

    out = []
    for main in (cli.main, jax_main):
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            main(argv)
        cap = capsys.readouterr()
        out.append((e.value.code, [ln.replace("klogs-torch", "klogs")
                                   for ln in cap.err.splitlines()
                                   if "error:" in ln]))
    assert out[0] == out[1]
    assert out[0][0] == 2 and len(out[0][1]) == 1


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path):
    """--profile DIR: a torch.profiler trace of the run lands in DIR (on
    the CPU it records the CPU's activity)."""
    fc = FakeCluster.synthetic(n_pods=2, lines_per_container=30,
                               clock=lambda: CLOCK)
    prof = tmp_path / "prof"
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(tmp_path / "o"),
                           "--match", "ERROR", "--profile", str(prof)])
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    traces = list(prof.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
    with open(traces[0]) as f:
        doc = json.load(f)
    assert doc["traceEvents"]


@pytest.mark.parametrize("raw", ["auto", "AUTO", "sometimes"])
def test_tune_mode_equals_jax(raw, tmp_path, monkeypatch, capsys):
    """KLOGS_TUNE: ``auto`` in any case is ``auto`` as in the JAX package,
    and a run under it goes through the operating-point controller (its
    files exact, ``klogs_tune_value`` set); another value ends the run
    with the JAX package's message."""
    from klogs_tpu.ops.tune import tune_mode as jax_tune_mode
    from klogs_tpu_torch.ops.tune import operating_surface, tune_mode

    monkeypatch.setenv("KLOGS_TUNE", raw)
    auto = raw.lower() == "auto"
    if auto:
        assert tune_mode() == jax_tune_mode() == "auto"
    else:
        with pytest.raises(ValueError) as e:
            tune_mode()
        with pytest.raises(ValueError) as je:
            jax_tune_mode()
        assert str(e.value) == str(je.value)
    fc = FakeCluster.synthetic(n_pods=3, lines_per_container=400,
                               clock=lambda: CLOCK)
    out, stats = tmp_path / "out", tmp_path / "stats.json"
    capsys.readouterr()
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(out),
                           "--match", "ERROR", "--stats-json", str(stats)])
    from klogs_tpu_torch.ui import term

    if not auto:
        with pytest.raises(term.FatalError):
            asyncio.run(app.run_async(opts, backend=fc, device="cpu"))
        assert "KLOGS_TUNE" in capsys.readouterr().out
        return
    monkeypatch.setenv("KLOGS_TUNE_INTERVAL_S", "0.05")
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    pods = fc.namespaces["default"]
    assert read_all(out) == {
        f"{name}__c0.log": b"".join(
            ln for _, ln in pods[name].containers["c0"].lines
            if b"ERROR" in ln) for name in pods}
    with open(stats) as f:
        doc = json.load(f)
    values = {s["labels"]["param"]: s["value"]
              for s in doc["metrics"]["klogs_tune_value"]["samples"]}
    surface = operating_surface()
    assert set(values) == {"coalesce_lines", "max_in_flight"}
    initial = {"coalesce_lines": 8192, "max_in_flight": 16}
    for param, v in values.items():
        lo, hi = surface[param]
        assert min(lo, initial[param]) <= v <= max(hi, initial[param])
    assert PROFILER.enabled  # the controller's signals


def test_tune_telemetry(tmp_path, monkeypatch):
    """``tune_grouped`` counts each sweep and sets the winner's rate, in
    the caller's registry, as the JAX tuner does."""
    import torch

    from klogs_tpu_torch.ops import nfa, tune

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    r = obs.Registry()
    dp, live, acc = nfa.compile_grouped(["x"], device="cpu")
    cls = torch.zeros((8, 5), dtype=torch.int16)
    for lps in (100.0, 300.0):
        best = tune.tune_grouped(dp, live, acc, cls, quiet=True, registry=r,
                                 runner=lambda **v: lps * (2 if v else 1))
    assert best["fused"] is True
    assert r.family("klogs_engine_tune_runs_total").value == 2
    assert r.family("klogs_engine_tune_best_lines_per_second").value == 600.0
