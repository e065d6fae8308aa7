"""The port's pipeline profiler against the JAX package's: the stage
catalog, the same folded spans giving the same ``profile_doc()`` once
times are masked, the metric sync, the probes, the knobs' checks, the
ticker, and the coalescer's and fan-out's probes on the port's path.

Tolerance: ``t``, ``wall_s`` and every ``utilization`` (wall-clock
rates) are masked; busy-seconds, span counts, samples and the rest are
compared exactly."""

import asyncio
import random
import time

import pytest

from klogs_tpu import obs as jax_obs
from klogs_tpu.obs import profiler as jax_profiler
from klogs_tpu.obs import trace as jax_trace
from klogs_tpu_torch import obs
from klogs_tpu_torch.obs import profiler, trace

SIDES = {"jax": (jax_profiler, jax_trace, jax_obs),
         "torch": (profiler, trace, obs)}


@pytest.fixture(autouse=True)
def _clean_profilers():
    for prof, tr, _ in SIDES.values():
        prof.PROFILER.reset()
        tr.reset(None)
    yield
    for prof, tr, _ in SIDES.values():
        prof.PROFILER.reset()
        tr.reset(None)


def test_stage_catalog_equals_jax():
    """JAX's catalog, then the port's own card stages."""
    assert profiler.STAGES == jax_profiler.STAGES + profiler.CARD_STAGES
    assert profiler.CARD_STAGES == ("card.batch",)


def _mask(doc: dict) -> dict:
    doc = dict(doc, t=None, wall_s=None)
    doc["stages"] = {k: dict(v, utilization=None)
                     for k, v in doc["stages"].items()}
    return doc


def _fold(side: str, seed: int) -> tuple:
    """Feed one seeded stream of finished-span docs (nested stages, an
    unknown name, a missing duration) to a side's profiler and its
    registry; returns the masked doc and the synced families."""
    prof_mod, _, obs_mod = SIDES[side]
    p = prof_mod.PROFILER
    reg = obs_mod.Registry()
    p.enable(1.0)
    p.bind_registry(reg)
    p.add_probe("coalescer.queue_depth", lambda: 3)
    rng = random.Random(seed)
    # The catalog both packages fold (the port's card stages have no JAX
    # counterpart).
    names = list(jax_profiler.STAGES) + ["not.a.stage"]
    docs = []
    for i in range(300):
        parent = (f"{rng.randrange(40):016x}" if rng.random() < 0.6
                  else None)
        dur = round(rng.random() / 100, 6) if rng.random() > 0.05 else None
        docs.append({"name": rng.choice(names), "duration_s": dur,
                     "span_id": f"{i:016x}", "parent_id": parent,
                     "trace_id": "t" * 32})
    p.tick()
    for d in docs:
        p.on_span(d)
    doc = p.tick()
    fams = {n: [(lv, c.value) for lv, c in reg.get(n).children()]
            for n in ("klogs_profile_stage_busy_seconds_total",
                      "klogs_profile_stage_spans_total")}
    return _mask(doc), _mask(p.profile_doc()), fams


@pytest.mark.parametrize("seed", [1, 2])
def test_profile_doc_equals_jax(seed):
    got = _fold("torch", seed)
    exp = _fold("jax", seed)
    assert got == exp
    assert got[0]["samples"] == {"coalescer.queue_depth": 3.0}
    assert got[0]["stages"], "nothing folded"


def test_fold_self_time_subtracts_children():
    p = profiler.PROFILER
    p.enable(1.0)
    p.on_span({"name": "device.fetch", "duration_s": 0.3, "span_id": "c",
               "parent_id": "p"})
    p.on_span({"name": "coalescer.dispatch", "duration_s": 0.5,
               "span_id": "p", "parent_id": None})
    doc = p.tick(io=False)
    assert doc["stages"]["coalescer.dispatch"]["busy_s"] == pytest.approx(0.2)
    assert doc["stages"]["device.fetch"]["busy_s"] == pytest.approx(0.3)


def test_card_batch_folds_as_a_stage_beside_its_parent():
    """``card.batch`` (the card's own time, on its timeline) folds its
    busy-seconds and leaves its parent's self time whole."""
    trace.reset(1.0)
    p = profiler.PROFILER
    p.enable(1.0)
    with trace.TRACER.span("coalescer.dispatch") as group:
        with trace.TRACER.span("device.fetch"):
            time.sleep(0.02)
        trace.TRACER.record_span("card.batch", group, time.time() - 0.015,
                                 0.015)
    doc = p.tick(io=False)
    card = doc["stages"]["card.batch"]
    assert card == {"busy_s": pytest.approx(0.015), "spans": 1,
                    "utilization": 0.0}
    fetch = doc["stages"]["device.fetch"]["busy_s"]
    assert doc["stages"]["coalescer.dispatch"]["busy_s"] < 0.015
    assert doc["stages"]["coalescer.dispatch"]["busy_s"] == pytest.approx(
        group.duration_s - fetch, abs=1e-6)


def test_disabled_profiler_installs_nothing():
    trace.reset(1.0)
    assert not profiler.PROFILER.enabled
    assert profiler.PROFILER.tick() is None
    with trace.TRACER.span("device.fetch"):
        pass
    assert profiler.PROFILER.profile_doc() == {
        "enabled": False, "stages": {}, "samples": {}, "bottleneck": None}


@pytest.mark.parametrize("name, raw", [
    ("KLOGS_PROFILE_SAMPLE", "0"), ("KLOGS_PROFILE_SAMPLE", "0.5"),
    ("KLOGS_PROFILE_SAMPLE", "2"), ("KLOGS_PROFILE_SAMPLE", "x"),
    ("KLOGS_PROFILE_INTERVAL_S", "0"), ("KLOGS_PROFILE_INTERVAL_S", "nan"),
    ("KLOGS_PROFILE_INTERVAL_S", "0.25"),
])
def test_knobs_checked_as_jax(name, raw, monkeypatch):
    monkeypatch.setenv(name, raw)
    out = {}
    for side, (prof_mod, tr, _) in SIDES.items():
        prof_mod.PROFILER.reset()
        tr.reset(None)
        try:
            on = prof_mod.PROFILER.enable()
            out[side] = (on, prof_mod.PROFILER._interval_s,
                         tr.TRACER.sample_rate())
        except ValueError as e:
            out[side] = str(e)
    assert out["torch"] == out["jax"]


def test_enable_raises_trace_sampling_unless_pinned(monkeypatch):
    trace.reset(None)
    profiler.PROFILER.enable(0.5)
    assert trace.TRACER.sample_rate() == 0.5
    profiler.PROFILER.reset()
    monkeypatch.setenv("KLOGS_TRACE_SAMPLE", "0.1")
    trace.reset(None)
    profiler.PROFILER.enable(1.0)
    assert trace.TRACER.sample_rate() == 0.1


def test_run_ticker_writes_a_final_tick(tmp_path):
    p = profiler.PROFILER
    p.enable(1.0)
    path = tmp_path / "p.jsonl"
    p.set_json_path(str(path))

    async def main():
        stop = asyncio.Event()
        task = asyncio.create_task(p.run_ticker(stop, interval_s=0.02))
        await asyncio.sleep(0.1)
        stop.set()
        await asyncio.wait_for(task, 5)

    asyncio.run(main())
    assert len(path.read_text().splitlines()) >= 2


def test_process_metrics_refresh():
    r = obs.Registry()
    profiler.refresh_process_metrics(r)
    assert r.family("klogs_process_uptime_seconds").value > 0
    assert r.family("klogs_process_rss_bytes").value > 0


def test_coalescer_and_fanout_probes_registered_and_dropped():
    """The async service registers its four probes while it lives, the
    fan-out its open-stream probe while it runs."""
    from klogs_tpu_torch.cluster.fake import FakeCluster
    from klogs_tpu_torch.cluster.types import LogOptions
    from klogs_tpu_torch.filters.async_service import AsyncFilterService
    from klogs_tpu_torch.filters.base import FilterStats, LogFilter
    from klogs_tpu_torch.runtime.fanout import FanoutRunner, plan_jobs

    class Echo(LogFilter):
        def match_lines(self, lines):
            return [True] * len(lines)

    p = profiler.PROFILER
    p.enable(1.0)
    svc = AsyncFilterService(Echo(), stats=FilterStats())
    names = ("coalescer.queue_depth", "coalescer.pending_lines",
             "device.in_flight_used", "device.fetch_queue")
    assert set(names) <= set(p.tick(io=False)["samples"])
    seen = {}

    class Probe:
        async def write(self, chunk):
            seen.update(p.tick(io=False)["samples"])

        async def close(self):
            pass

        async def flush(self):
            pass

        bytes_written = 0

    async def main():
        fc = FakeCluster.synthetic(n_pods=2, lines_per_container=5)
        runner = FanoutRunner(fc, "default", LogOptions(),
                              sink_factory=lambda job: Probe(),
                              create_files=False)
        await runner.run(plan_jobs(await fc.list_pods("default"), "/x",
                                  False))
        await svc.aclose()

    asyncio.run(main())
    assert seen["fanout.active_streams"] >= 1
    assert not set(names) & set(p.tick(io=False)["samples"])
    assert "fanout.active_streams" not in p.tick(io=False)["samples"]
