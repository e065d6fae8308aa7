"""The readers of a frame's life in filterd, each on a synthetic window
(``card.*`` spans and the fetch, loop-lag and receive families), and
``frame_life``'s reading of the card spans against the device trace."""

import pytest

from portbench import frame_life, spec, tracing


def _read(name: str, tr):
    return spec.reader(spec.BENCH_DIR, name).read(tr)


def _span(name, span_id, start, dur, parent=None, **attrs):
    return {"name": name, "span_id": span_id, "parent_id": parent,
            "start_unix": start, "duration_s": dur, "attrs": attrs}


WINDOW = tracing.Trace(
    t0=10.0, t1=11.0, has_device_trace=True,
    spans=[
        # Started before the window: not read.
        _span("card.batch", "a", 9.99, 0.02, queued_s=0.5, rows=8),
        _span("card.gate", "ag", 9.995, 0.001, parent="a"),
        _span("card.batch", "b", 10.1, 0.03, queued_s=0.2, rows=8),
        _span("card.gate", "bg1", 10.101, 0.002, parent="b"),
        _span("card.gate", "bg2", 10.11, 0.001, parent="b"),
        _span("card.batch", "c", 10.2, 0.01, queued_s=0.1, rows=8),
        _span("card.match", "cm", 10.201, 0.005, parent="c"),
        _span("card.batch", "d", 10.3, 0.02, queued_s=0.0, rows=8),
        _span("card.gate", "dg", 10.301, 0.004, parent="d"),
    ],
    counters={"klogs_fetch_wait_seconds_total": (8.0, 0.0),
              "klogs_fetch_cpu_seconds_total": (6.0, 0.0),
              "klogs_loop_lag_seconds": (0.12, 40.0),
              "klogs_rpc_receive_seconds": (1.5, 30.0)},
    device=[("kernel", "z", 10.105, 10.115), ("kernel", "a", 10.205, 10.215),
            ("memcpy", "Memcpy HtoD (Pinned -> Device)", 10.10002, 10.101),
            ("memcpy", "Memcpy HtoD (Pinned -> Device)", 10.20004, 10.201)])


@pytest.mark.parametrize("name, want", [
    ("card_queue_ms", (0.2 + 0.1 + 0.0) / 3 * 1e3),
    ("card_ms_per_batch", (0.03 + 0.01 + 0.02) / 3 * 1e3),
    ("card_gate_ms_per_batch", (0.003 + 0.004) / 2 * 1e3),
    ("fetch_cpu_share", 0.75),
    ("loop_lag_ms", 3.0),
    ("rpc_receive_ms", 50.0),
])
def test_reader_on_a_tiny_window(name, want):
    assert _read(name, WINDOW) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "card_queue_ms", "card_ms_per_batch", "card_gate_ms_per_batch",
    "fetch_cpu_share", "loop_lag_ms", "rpc_receive_ms"])
def test_reader_finds_nothing_in_a_window_without_them(name):
    """The parent's program has none of these spans and families."""
    tr = tracing.Trace(t0=0.0, t1=1.0, spans=[
        _span("device.frame", "f", 0.1, 0.01, rows=2, staged=True)],
        counters={"klogs_coalescer_group_lines": (10.0, 1.0)})
    assert _read(name, tr) is None


def test_no_wait_reads_no_share():
    tr = tracing.Trace(t0=0.0, t1=1.0, counters={
        "klogs_fetch_wait_seconds_total": (0.0, 0.0),
        "klogs_fetch_cpu_seconds_total": (0.0, 0.0)})
    assert _read("fetch_cpu_share", tr) is None


def test_frame_life_reads_the_held_share_and_the_copy_offsets():
    # Between b's start (10.1) and d's end (10.32) the kernels run 20 ms,
    # of which 10 + 5 lie inside b and c.
    assert frame_life.held_share(WINDOW) == pytest.approx(15 / 20)
    assert frame_life.copy_offsets_us(WINDOW) == pytest.approx([20, 40])
    assert frame_life.quartiles([1.0]) is None


def test_frame_life_partitions_a_sampled_rpc():
    def traced(name, start, dur, **attrs):
        return dict(_span(name, name, start, dur, **attrs), trace_id="t")

    tr = tracing.Trace(t0=0.0, t1=1.0, spans=[
        traced("rpc.receive", 0.09, 0.01),
        traced("rpc.server", 0.1, 0.5, method="MatchFramed"),
        traced("coalescer.dispatch", 0.12, 0.45),
        traced("card.batch", 0.3, 0.2, queued_s=0.1),
        dict(_span("rpc.server", "x", 0.2, 0.1), trace_id="lone")])
    got = frame_life.per_rpc_ms(tr)
    assert got == pytest.approx({"receive": 10, "to_dispatch": 20,
                                 "to_card": 180, "card": 200,
                                 "after_card": 100, "server": 500,
                                 "rpcs": 1})
