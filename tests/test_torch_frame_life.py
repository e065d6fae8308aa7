"""A frame's life in filterd, as the port times it: the card's own spans
from CUDA events (``filters/gpu.py`` ``CardTimer``), the fetch threads'
wait and CPU time (``filters/async_service.py``), the event loop's lag
and each RPC's receive (``service/server.py``), and the tracer's
``record_span`` they rest on.

On the CPU there are no CUDA events: the engine's card timing is forced
on with a timer that records its marks, and a real ``CardTimer`` is fed
events of known times. ``tests/test_torch_cuda.py`` holds the same spans
against ``torch.profiler`` on the card."""

import asyncio
import time

import numpy as np
import pytest
import torch

from klogs_tpu_torch import obs
from klogs_tpu_torch.filters import gpu
from klogs_tpu_torch.filters.async_service import AsyncFilterService
from klogs_tpu_torch.filters.base import FilterStats, LogFilter, frame_lines
from klogs_tpu_torch.filters.gpu import CardTimer, GpuEngineFilter
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.service.client import RemoteFilterClient
from klogs_tpu_torch.service.server import FilterServer, LoopLag

PATTERNS = ["panic:", r"retry \d+/\d+", "code=50[34]"]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_tracer():
    trace.reset(None)
    yield
    trace.reset(None)


def _spans() -> list:
    got: list = []
    trace.TRACER.add_sink(got.append)
    return got


def _frame(n_short: int = 40, n_long: int = 2) -> tuple:
    lines = [b"retry 3/5 at x" if i % 7 == 0 else b"a quiet line %d" % i
             for i in range(n_short)]
    lines += [b"y" * 5000 + b" panic: " + b"z" * (900 * i)
              for i in range(n_long)]
    return frame_lines(lines)[:2]


# -- the engine's card timing -------------------------------------------


class _MarkingTimer:
    """A ``CardTimer`` stand-in that keeps its marks."""

    made: list = []

    def __init__(self, device, parent):
        self.parent = parent
        self.marks: list = []
        self.sub_batches = self.launches = 0
        _MarkingTimer.made.append(self)

    def start(self):
        self.marks.append(("start", {}))

    def mark(self, stage, **attrs):
        self.marks.append((stage, attrs))


@pytest.fixture
def marking(monkeypatch):
    _MarkingTimer.made = []
    monkeypatch.setattr(gpu, "CardTimer", _MarkingTimer)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    return _MarkingTimer


@pytest.mark.parametrize("prefilter", ["0", "1"], ids=["k1", "gated"])
def test_untraced_dispatch_makes_no_timing_event_and_no_card_span(
        marking, prefilter, monkeypatch):
    """Tracing off, an engine that times the card makes no timer, no
    event and no span; traced, its timer marks each stage in order (the
    gate's end after K3's pair builder), under the span current at
    dispatch."""
    monkeypatch.setenv("KLOGS_TPU_PREFILTER", prefilter)
    filt = GpuEngineFilter(PATTERNS, device="cpu")
    assert (filt._pf_tables is not None) == (prefilter == "1")
    assert filt._card_timing is False
    filt._card_timing = True
    payload, offsets = _frame()
    spans = _spans()
    trace.reset(0.0)
    trace.TRACER.add_sink(spans.append)
    want = filt.fetch_framed(filt.dispatch_framed(payload, offsets))
    assert marking.made == [] and spans == []

    trace.reset(1.0)
    trace.TRACER.add_sink(spans.append)
    with trace.TRACER.span("coalescer.dispatch") as group:
        got = filt.fetch_framed(filt.dispatch_framed(payload, offsets))
    assert np.array_equal(got, want) and want.any()
    (timer,) = marking.made
    gate = ["gate"] if prefilter == "1" else []
    assert [m[0] for m in timer.marks] == ["start", "copy", "pack", *gate,
                                           "match", "long"]
    assert timer.marks[2][1] == timer.marks[-2][1] == {"width": 128}
    assert timer.marks[-1][1] == {"chunks": 2}
    assert timer.sub_batches == 2
    assert timer.launches == 1 + 2
    assert timer.parent.span_id == group.span_id
    assert timer.parent.trace_id == group.trace_id
    assert not any(s["name"].startswith("card.") for s in spans)


def test_a_mesh_engine_times_no_card():
    from klogs_tpu_torch.parallel.mesh import MeshEngine

    cpu = torch.device("cpu")
    eng = MeshEngine(PATTERNS, devices=[cpu] * 2, grid=(2, 1))
    assert GpuEngineFilter(PATTERNS, engine=eng)._card_timing is False


class _Event:
    """A finished CUDA event at ``ms`` after the anchor."""

    def __init__(self, ms: float):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other: "_Event") -> float:
        return other.ms - self.ms


def test_card_timer_records_the_batch_and_its_stages_inside_it():
    timer = CardTimer.__new__(CardTimer)
    timer.anchor = (_Event(0.0), 1000.0, 0.0)
    timer.parent = trace.SpanContext(7, 9, True)
    timer.enqueued_unix = 1000.001
    timer.sub_batches, timer.launches = 2, 4
    timer.marks = [("start", _Event(5.0), {}), ("copy", _Event(6.0), {}),
                   ("pack", _Event(6.5), {"width": 128}),
                   ("gate", _Event(8.0), {"width": 128}),
                   ("match", _Event(9.0), {"width": 128}),
                   ("long", _Event(20.0), {"chunks": 3})]
    trace.reset(1.0)
    spans = _spans()
    timer.finish(_Event(20.25), rows=42)
    batch = spans[0]
    assert batch["name"] == "card.batch"
    assert batch["parent_id"] == f"{9:016x}"
    assert batch["start_unix"] == pytest.approx(1000.005)
    assert batch["duration_s"] == pytest.approx(0.01525)
    assert batch["attrs"] == {"queued_s": pytest.approx(0.004), "rows": 42,
                              "sub_batches": 2, "launches": 4}
    kids = spans[1:]
    assert [s["name"] for s in kids] == [
        "card.copy", "card.pack", "card.gate", "card.match", "card.long",
        "card.verdicts"]
    assert kids[4]["attrs"] == {"chunks": 3}
    end = batch["start_unix"] + batch["duration_s"]
    at = batch["start_unix"]
    for s in kids:
        assert s["parent_id"] == batch["span_id"]
        assert s["trace_id"] == batch["trace_id"]
        assert s["start_unix"] == pytest.approx(at, abs=1e-9)
        at = s["start_unix"] + s["duration_s"]
        assert at <= end + 1e-9
    assert at == pytest.approx(end, abs=1e-9)


# -- the fetch threads ---------------------------------------------------


class _SleepThenSpin(LogFilter):
    """A filter whose fetch waits ``sleep_s`` and then spins for
    ``spin_s`` of its thread's CPU time."""

    sleep_s, spin_s = 0.03, 0.02

    def dispatch_framed(self, payload, offsets):
        return len(offsets) - 1

    def fetch_framed(self, handle):
        time.sleep(self.sleep_s)
        t0 = time.thread_time()
        while time.thread_time() - t0 < self.spin_s:
            pass
        return np.zeros(handle, dtype=bool)

    def match_lines(self, lines):
        return [False] * len(lines)


def test_fetch_counters_advance_by_one_wait_a_batch():
    reg = obs.Registry()
    svc = AsyncFilterService(_SleepThenSpin(), stats=FilterStats(registry=reg),
                             coalesce_delay_s=0.001)
    payload, offsets = _frame(8, 0)

    async def run():
        try:
            for _ in range(3):
                await svc.match_framed(payload, offsets)
        finally:
            await svc.aclose()

    asyncio.run(run())
    assert reg.family("klogs_coalescer_groups_total").value == 3
    wait = reg.family("klogs_fetch_wait_seconds_total").value
    cpu = reg.family("klogs_fetch_cpu_seconds_total").value
    per = _SleepThenSpin.sleep_s + _SleepThenSpin.spin_s
    assert 3 * per <= wait < 3 * per + 3 * 0.04
    assert 3 * _SleepThenSpin.spin_s <= cpu < wait


# -- the event loop and the RPC's receive --------------------------------


def test_loop_lag_observes_a_blocked_loop_and_stops():
    reg = obs.Registry()
    hist = reg.family("klogs_loop_lag_seconds")
    lag = LoopLag(hist, period_s=0.01)

    async def run():
        lag.start(asyncio.get_running_loop())
        await asyncio.sleep(0.05)
        time.sleep(0.12)  # the loop blocked
        await asyncio.sleep(0.03)
        lag.stop()
        n = hist.count
        await asyncio.sleep(0.05)
        return n

    n = asyncio.run(run())
    _, total, count = hist.children()[0][1].snapshot()
    assert count == n >= 3
    assert not lag.running
    assert total >= 0.1


def test_loop_lag_starts_and_stops_with_the_server():
    async def run():
        server = FilterServer(PATTERNS, port=0, device="cpu", metrics_port=0)
        hist = server.registry.family("klogs_loop_lag_seconds")
        assert hist.count == 0
        await server.start()
        try:
            assert server._loop_lag.running
            await asyncio.sleep(0.3)
        finally:
            await server.stop()
        n = hist.count
        await asyncio.sleep(0.15)
        return server, n, hist.count

    server, n, later = asyncio.run(run())
    assert n >= 3 and later == n
    assert not server._loop_lag.running


def test_rpc_receive_ends_where_rpc_server_starts():
    """A sampled RPC's ``rpc.receive`` is a child of its ``rpc.server``
    span, in its trace, ending where it starts; every RPC, sampled or
    not, is one observation of ``klogs_rpc_receive_seconds``."""
    payload, offsets = _frame(16, 1)

    async def run():
        server = FilterServer(PATTERNS, port=0, device="cpu", metrics_port=0)
        port = await server.start()
        client = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await client.hello()
            trace.reset(1.0)
            spans = _spans()
            for _ in range(3):
                await client.match_framed(payload, offsets)
            trace.reset(0.0)
            await client.match_framed(payload, offsets)
        finally:
            await client.aclose()
            await server.stop()
        return server.registry, spans

    reg, spans = asyncio.run(run())
    fam = reg.family("klogs_rpc_receive_seconds")
    counts = {key[0]: c.count for key, c in fam.children()}
    assert counts.get("MatchFramed") == 4
    assert counts.get("Hello", 0) >= 1
    servers = {s["span_id"]: s for s in spans if s["name"] == "rpc.server"
               and s["attrs"]["method"] == "MatchFramed"}
    receives = [s for s in spans if s["name"] == "rpc.receive"]
    assert len(servers) == len(receives) == 3
    for r in receives:
        srv = servers[r["parent_id"]]
        assert r["trace_id"] == srv["trace_id"]
        assert r["attrs"] == {"method": "MatchFramed"}
        assert r["duration_s"] >= 0
        assert r["start_unix"] + r["duration_s"] == pytest.approx(
            srv["start_unix"], abs=1e-6)
