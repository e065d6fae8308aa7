"""FilteredSink and FilterPipeline: the write-gating stage.

Counterpart of ``klogs_tpu/filters/sink.py``. A FilteredSink sits where
a container's log bytes would be written: it frames chunks into lines,
asks the filter for a keep-mask once ``BATCH_LINES`` lines are pending,
when the oldest pending line has waited ``deadline_s`` (checked at the
next write and by the pipeline's follow-mode deadline flusher), and at
close, and writes only kept lines, in the original order.
``make_pipeline`` builds the shared engine, its AsyncFilterService and
the per-container sink factory.

Each flush is a ``sink.flush`` span (a child of the chunk's
``fanout.read`` span, or a root under the deadline flusher and at
close), and the write of its kept lines a ``sink.write`` span (``bytes``
and, beyond the JAX span's attributes, ``lines``). The
``sink.degrade`` event and its flight-recorder trigger mark a batch the
filter service could not filter (``Unavailable``); the port's in-process
service never raises that, and with no ``--on-filter-error`` yet the
batch's error ends the run, as the JAX default ``abort`` does.
"""

import asyncio
import time
from dataclasses import dataclass
from dataclasses import field as dataclasses_field
from typing import Callable

import numpy as np

from klogs_tpu_torch.filters.async_service import AsyncFilterService
from klogs_tpu_torch.filters.base import FilterStats, LogFilter, build_include_exclude
from klogs_tpu_torch.filters.framer import FramedBatcher, join_kept_framed
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience.policy import Unavailable
from klogs_tpu_torch.runtime.fanout import StreamJob
from klogs_tpu_torch.runtime.sink import FileSink, Sink
from klogs_tpu_torch.ui import term

# Lines a sink gathers before it asks for their verdicts; the service
# coalesces the batches of many sinks into one device batch.
BATCH_LINES = 8192
# How long a pending line may wait for its verdict in follow mode.
DEADLINE_S = 0.05


class FilteredSink(Sink):
    def __init__(self, inner: Sink, service: AsyncFilterService,
                 stats: FilterStats, deadline_s: float = DEADLINE_S,
                 on_close: "Callable[[FilteredSink], None] | None" = None):
        self._inner = inner
        self._service = service
        self._stats = stats
        self._deadline_s = deadline_s
        self._on_close = on_close
        self._closed = False
        self._batcher = FramedBatcher()
        # When the oldest pending line arrived (None: nothing pending).
        self._pending_since: float | None = None
        # Held across match + write so two flushes of this file (a write
        # and the deadline flusher) cannot reorder its lines while a
        # batch is in flight. Created at first flush, inside the running
        # loop.
        self._flush_lock: "asyncio.Lock | None" = None

    async def write(self, chunk: bytes) -> None:
        had = self._batcher.pending_lines
        n = self._batcher.feed(chunk)
        if n and not had:
            self._pending_since = time.perf_counter()
        if n >= BATCH_LINES or (
                n and self._pending_since is not None
                and time.perf_counter() - self._pending_since
                >= self._deadline_s):
            await self._flush_pending()

    async def _flush_pending(self, final: bool = False) -> None:
        if self._flush_lock is None:
            self._flush_lock = asyncio.Lock()
        with trace.TRACER.span("sink.flush",
                               pending=self._batcher.pending_lines):
            async with self._flush_lock:
                await self._flush_locked(final)

    async def _flush_locked(self, final: bool) -> None:
        payload, offsets, n = self._batcher.take(final=final)
        self._pending_since = None
        if n == 0:
            return
        t0 = time.perf_counter()
        try:
            mask = await self._service.match_framed(payload, offsets)
        except Unavailable as e:
            self._degrade(e)
            raise
        latency = time.perf_counter() - t0
        n_kept = int(np.count_nonzero(mask))
        out = join_kept_framed(payload, offsets, mask)
        if out:
            with trace.TRACER.span("sink.write", bytes=len(out),
                                   lines=n_kept):
                await self._inner.write(out)
        self._stats.record_batch(
            n_lines=n, n_matched=n_kept, n_bytes_in=len(payload),
            n_bytes_out=len(out), latency_s=latency)

    @staticmethod
    def _degrade(e: Unavailable) -> None:
        """A batch the filter service could not filter: annotate it and
        arm a flight-recorder dump. The action is the JAX default,
        ``abort``: the caller raises."""
        trace.TRACER.event("sink.degrade", action="abort", error=str(e))
        trace.flight_trigger("filter-degrade", action="abort",
                             error=str(e))

    async def flush_if_stale(self) -> None:
        """Flush the pending lines once the oldest has waited
        ``deadline_s`` (the follow-mode flusher calls this)."""
        if (self._batcher.pending_lines
                and self._pending_since is not None
                and time.perf_counter() - self._pending_since
                >= self._deadline_s):
            self._stats.record_deadline_flush()
            await self._flush_pending()
            # Live tailing: matched lines must reach the file, not sit in
            # the inner sink's write buffer.
            await self._inner.flush()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._on_close is not None:
            self._on_close(self)
        try:
            await self._flush_pending(final=True)
        finally:
            # The file is released even when the final flush fails.
            await self._inner.close()

    @property
    def bytes_written(self) -> int:
        return self._inner.bytes_written


@dataclass
class FilterPipeline:
    """One engine, its service and its stats, shared by every
    per-container sink."""

    log_filter: LogFilter
    stats: FilterStats
    service: AsyncFilterService
    deadline_s: float = DEADLINE_S
    # Where kept lines land; None = a FileSink on job.path. ``-o
    # stdout|both`` injects console and tee factories.
    inner_factory: "Callable[[StreamJob], Sink] | None" = None
    _live_sinks: "set[FilteredSink]" = dataclasses_field(default_factory=set)

    def sink_factory(self, job: StreamJob) -> Sink:
        inner = (self.inner_factory(job) if self.inner_factory is not None
                 else FileSink(job.path))
        sink = FilteredSink(inner, self.service, self.stats,
                            deadline_s=self.deadline_s,
                            on_close=self._live_sinks.discard)
        self._live_sinks.add(sink)
        return sink

    async def run_deadline_flusher(self,
                                   stop: "asyncio.Event | None" = None
                                   ) -> None:
        """Follow mode's latency bound: every ``deadline_s / 2`` force
        the stale pending lines of every live sink through the filter,
        so a matching line of a quiet container reaches its file within
        about ``deadline_s`` with no further input. A background task;
        cancel it to stop. The sweep runs the sinks concurrently (they
        merge into a few device batches in the service), and one sink's
        failure is reported and does not stop the others: its own
        worker meets the fault at its next write. ``stop`` is the run's
        stop event, taken for the JAX signature; nothing here sets it
        (the JAX flusher sets it only under ``--on-filter-error``)."""
        while True:
            await asyncio.sleep(self.deadline_s / 2)
            results = await asyncio.gather(
                *[s.flush_if_stale() for s in list(self._live_sinks)],
                return_exceptions=True)
            for r in results:
                if isinstance(r, Exception):
                    term.warning("deadline flush failed: %s", r)

    async def aclose(self) -> None:
        """Drain in-flight batches, then release the service and engine."""
        await self.service.aclose()

    def print_summary(self) -> None:
        s = self.stats
        term.info(
            "Filter stats: %d lines in, %d matched (%.1f%%), %.0f lines/sec, "
            "batch latency p50=%.2fms p99=%.2fms (%d batches)",
            s.lines_in, s.lines_matched, s.matched_pct(), s.lines_per_sec(),
            s.percentile_latency_s(50) * 1e3, s.percentile_latency_s(99) * 1e3,
            s.batches,
        )
        if s.has_service_latencies:
            term.info(
                "  queue p50=%.2fms p99=%.2fms | device p50=%.2fms p99=%.2fms",
                s.percentile_queue_s(50) * 1e3, s.percentile_queue_s(99) * 1e3,
                s.percentile_device_s(50) * 1e3,
                s.percentile_device_s(99) * 1e3,
            )
        if s.pf_lines:
            term.info(
                "  prefilter: %.1f%% candidates (%d/%d lines), "
                "%d/%d tiles skipped",
                100.0 * s.pf_candidates / s.pf_lines,
                s.pf_candidates, s.pf_lines,
                s.pf_tiles_total - s.pf_tiles_live, s.pf_tiles_total,
            )
        elif s.pf_disabled_reason:
            term.info("  %s", s.pf_disabled_reason)


def make_pipeline(patterns: list[str], backend: str = "cuda",
                  ignore_case: bool = False,
                  exclude: list[str] | None = None,
                  device=None, registry=None) -> FilterPipeline:
    """The --match/--exclude pipeline on the GPU engine. ``device=None``
    means ``"cuda"`` (raising where there is no card); tests pass
    ``"cpu"``. ``registry`` (an obs Registry) backs the stats for a
    /metrics sidecar or a --stats-json dump; None keeps them private."""
    if backend != "cuda":
        raise ValueError(f"unknown filter backend {backend!r}")
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter

    stats = FilterStats(registry=registry)
    log_filter = build_include_exclude(
        lambda pats: GpuEngineFilter(pats, ignore_case=ignore_case,
                                     device=device, stats=stats),
        patterns, exclude)
    return FilterPipeline(
        log_filter=log_filter,
        stats=stats,
        service=AsyncFilterService(log_filter, stats=stats),
    )
