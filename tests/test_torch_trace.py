"""The port's tracer and flight recorder against the JAX package's: the
same span and event sequence under the same seeded id generator gives
the same JSON lines once times are masked, and the same head-sampling
decisions; the sample-rate checks, the JSON-lines sink, the recorder's
dumps, and the span tree of a run through the port's app.

Tolerance: every field is compared exactly except ``start_unix``,
``duration_s`` and events' ``t_s`` (times)."""

import asyncio
import json
import random

import pytest
import torch

from klogs_tpu.obs import trace as jax_trace
from klogs_tpu.resilience import policy as jax_policy
from klogs_tpu_torch import app, cli
from klogs_tpu_torch.cluster.fake import FakeCluster
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience import policy


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLOCK = 1_753_800_000.0
SIDES = {"jax": (jax_trace, jax_policy), "torch": (trace, policy)}


@pytest.fixture(autouse=True)
def _clean_tracers():
    for tr, _ in SIDES.values():
        tr.reset(None)
    yield
    for tr, _ in SIDES.values():
        tr.reset(None)
        tr.RECORDER._dir = None
        tr.RECORDER._min_interval_s = 30.0


def _mask(doc: dict) -> dict:
    doc = dict(doc)
    doc["start_unix"] = doc["duration_s"] = None
    doc["events"] = [{k: (None if k == "t_s" else v) for k, v in e.items()}
                     for e in doc["events"]]
    return doc


def _script(tr, seed: int, rate: float, tmp_path) -> list:
    """A seeded sequence of roots, children, events, attributes, errors
    and cancellations; returns the JSON lines the file sink wrote."""
    tr._IDS.seed(seed)
    tr.reset(rate)
    path = tmp_path / f"{tr.__name__}-{seed}-{rate}.jsonl"
    tr.TRACER.set_json_path(str(path))
    rng = random.Random(seed)
    for i in range(40):
        try:
            with tr.TRACER.span("fanout.read", pod=f"pod-{i % 3}",
                                bytes=rng.randrange(1 << 20)) as root:
                root.set_attr("long", "x" * rng.randrange(400))
                with tr.TRACER.span("sink.flush", pending=i):
                    tr.TRACER.event("coalescer.enqueue", lines=i,
                                    queue_depth=rng.randrange(9))
                    with tr.TRACER.span("device.fetch"):
                        pass
                kind = rng.randrange(4)
                if kind == 0:
                    raise ValueError(f"boom {i}")
                if kind == 1:
                    raise asyncio.CancelledError()
        except (ValueError, asyncio.CancelledError):
            pass
    tr.TRACER.set_json_path(None)
    if not path.exists():
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("seed, rate", [(1, 1.0), (2, 0.5), (3, 0.2),
                                        (4, 0.0)])
def test_spans_and_sampling_equal_jax(seed, rate, tmp_path):
    got = _script(trace, seed, rate, tmp_path)
    exp = _script(jax_trace, seed, rate, tmp_path)
    assert [_mask(d) for d in got] == [_mask(d) for d in exp]
    roots = {d["trace_id"] for d in got}
    if rate == 1.0:
        assert len(roots) == 40 and len(got) == 120
    elif rate == 0.0:
        assert got == []
    else:
        assert 0 < len(roots) < 40
    statuses = {d["status"] for d in got if d["name"] == "fanout.read"}
    if rate == 1.0:
        assert statuses == {"ok", "error", "cancelled"}


@pytest.mark.parametrize("raw", ["0", "1", "0.25", "1.5", "-0.1", "abc",
                                 "nan"])
def test_sample_env_checked_as_jax(raw, monkeypatch):
    monkeypatch.setenv("KLOGS_TRACE_SAMPLE", raw)
    out = {}
    for side, (tr, _) in SIDES.items():
        tr.reset(None)
        try:
            out[side] = tr.TRACER.sample_rate()
        except ValueError as e:
            out[side] = str(e)
    assert out["torch"] == out["jax"]


def test_enable_default_and_ensure_sample_respect_the_env(monkeypatch):
    trace.reset(None)
    trace.TRACER.enable_default()
    assert trace.TRACER.sample_rate() == 1.0
    monkeypatch.setenv("KLOGS_TRACE_SAMPLE", "0")
    trace.reset(None)
    trace.TRACER.enable_default()
    trace.TRACER.ensure_sample(1.0)
    assert trace.TRACER.sample_rate() == 0.0
    assert trace.TRACER.span("x") is trace.NOOP_SPAN


def test_traceparent_roundtrip_equal_jax():
    for value in ("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
                  "00-" + "ab" * 16 + "-" + "cd" * 8 + "-00",
                  "00-xyz-" + "cd" * 8 + "-01", "garbage", "00-ab-cd-01"):
        got = trace.SpanContext.from_traceparent(value)
        exp = jax_trace.SpanContext.from_traceparent(value)
        assert (got is None) == (exp is None), value
        if got is not None:
            assert got.traceparent() == exp.traceparent() == value


def test_context_reaches_tasks_not_threads():
    trace.reset(1.0)
    seen = {}

    async def main():
        with trace.TRACER.span("fanout.read") as root:
            async def child():
                with trace.TRACER.span("sink.flush") as sp:
                    seen["task_parent"] = sp.parent_id
            await asyncio.create_task(child())
            seen["root"] = root.span_id

    asyncio.run(main())
    assert seen["task_parent"] == seen["root"]
    # An executor thread does not inherit the context (the await site
    # owns device.fetch).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        with trace.TRACER.span("x"):
            assert pool.submit(trace.TRACER.current_span).result() is None


def test_record_span_takes_the_given_start_and_duration_under_a_parent():
    """``record_span`` finishes a span at once, at the start and duration
    given, under a ``Span`` or a ``SpanContext``, from any thread; an
    unsampled or absent parent records nothing."""
    trace.reset(1.0)
    got = []
    trace.TRACER.add_sink(got.append)
    with trace.TRACER.span("coalescer.dispatch") as group:
        pass
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        batch = pool.submit(trace.TRACER.record_span, "card.batch", group,
                            1234.5, 0.25, rows=3).result()
    trace.TRACER.record_span("card.copy", batch.context(), 1234.5, 0.01)
    assert [d["name"] for d in got] == ["coalescer.dispatch", "card.batch",
                                        "card.copy"]
    b, c = got[1], got[2]
    assert (b["start_unix"], b["duration_s"], b["attrs"]) == (
        1234.5, 0.25, {"rows": 3})
    assert b["parent_id"] == f"{group.span_id:016x}"
    assert b["trace_id"] == c["trace_id"] == f"{group.trace_id:032x}"
    assert c["parent_id"] == b["span_id"] and not c["local_root"]
    assert trace.TRACER.current_span() is None
    assert trace.TRACER.record_span("x", None, 1.0, 1.0) is trace.NOOP_SPAN
    off = trace.SpanContext(1, 2, False)
    assert not trace.TRACER.record_span("x", off, 1.0, 1.0).sampled
    assert len(got) == 3


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_breaker_open_arms_a_recorder_dump(side, tmp_path):
    """A breaker opening inside a traced batch adds ``breaker.open`` and
    dumps the batch's story when its root ends, in both packages."""
    tr, pol = SIDES[side]
    tr.reset(1.0)
    tr.RECORDER.configure(dir_path=str(tmp_path), min_interval_s=0.0)
    br = pol.CircuitBreaker("svc", failure_threshold=2)
    with tr.TRACER.span("fanout.read"):
        with tr.TRACER.span("sink.flush") as sp:
            br.record_failure()
            br.record_failure()
            events = [e["name"] for e in sp.events]
    tr.RECORDER.join_writes()
    assert events == ["breaker.open"]
    assert len(tr.RECORDER.dumps) == 1
    with open(tr.RECORDER.dumps[0]) as f:
        doc = json.load(f)
    assert [r["reason"] for r in doc["reasons"]] == ["breaker-open"]
    assert [s["name"] for s in doc["spans"]] == ["sink.flush", "fanout.read"]


def test_recorder_flush_and_rate_limit(tmp_path):
    trace.reset(1.0)
    trace.RECORDER.configure(dir_path=str(tmp_path), min_interval_s=60.0)
    with trace.TRACER.span("device.fetch"):
        pass
    trace.flight_trigger("filter-degrade", action="abort")
    trace.flight_trigger("filter-degrade", action="abort")  # rate-limited
    path = trace.RECORDER.flush()
    assert path is not None and trace.RECORDER.dumps == [path]
    assert trace.RECORDER.flush() is None


def test_recorder_is_a_no_op_with_tracing_off(tmp_path):
    trace.reset(0.0)
    trace.RECORDER.configure(dir_path=str(tmp_path))
    trace.flight_trigger("breaker-open")
    assert trace.RECORDER.flush() is None
    assert list(tmp_path.iterdir()) == []


def test_app_span_tree(tmp_path):
    """A run through the port's app with --trace-json: every device span
    sits under a coalescer.dispatch, which sits under a sink.flush; each
    sink.write under its sink.flush; spans of one coalesced group share
    its trace."""
    fc = FakeCluster.synthetic(n_pods=3, lines_per_container=300,
                               clock=lambda: CLOCK)
    path = tmp_path / "t.jsonl"
    opts = cli.parse_args(["-n", "default", "-a", "-p", str(tmp_path / "o"),
                           "--match", "ERROR", "--trace-json", str(path)])
    assert asyncio.run(app.run_async(opts, backend=fc, device="cpu")) == 0
    with open(path) as f:
        spans = [json.loads(ln) for ln in f]
    by_id = {s["span_id"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert names == {"fanout.read", "sink.flush", "sink.write",
                     "coalescer.dispatch", "device.frame", "device.kernel",
                     "device.fetch"}

    def parent(s):
        return by_id.get(s["parent_id"]) if s["parent_id"] else None

    for s in spans:
        p = parent(s)
        if s["name"] == "device.fetch":
            assert p["name"] == "coalescer.dispatch"
        elif s["name"] in ("device.kernel",):
            assert p["name"] == "coalescer.dispatch"
            assert {"width", "rows"} <= set(s["attrs"])
        elif s["name"] == "device.frame":
            assert p["name"] in ("coalescer.dispatch", "device.frame")
            if p["name"] == "device.frame":
                assert set(s["attrs"]) == {"width", "rows", "path"}
                assert s["attrs"]["path"] == "cls"
        elif s["name"] == "coalescer.dispatch":
            assert p["name"] == "sink.flush"
        elif s["name"] == "sink.write":
            assert p["name"] == "sink.flush"
        if p is not None:
            assert p["trace_id"] == s["trace_id"]
