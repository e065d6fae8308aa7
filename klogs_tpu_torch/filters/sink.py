"""FilteredSink and FilterPipeline: the write-gating stage.

Counterpart of ``klogs_tpu/filters/sink.py``. A FilteredSink sits where
a container's log bytes would be written: it frames chunks into lines,
asks the filter for a keep-mask once ``BATCH_LINES`` lines are pending
(and at close), and writes only kept lines, in the original order.
``make_pipeline`` builds the shared engine, its AsyncFilterService and
the per-container sink factory.
"""

import asyncio
import time
from dataclasses import dataclass

import numpy as np

from klogs_tpu_torch.filters.async_service import AsyncFilterService
from klogs_tpu_torch.filters.base import FilterStats, LogFilter, build_include_exclude
from klogs_tpu_torch.filters.framer import FramedBatcher, join_kept_framed
from klogs_tpu_torch.runtime.fanout import StreamJob
from klogs_tpu_torch.runtime.sink import FileSink, Sink
from klogs_tpu_torch.ui import term

# Lines a sink gathers before it asks for their verdicts; the service
# coalesces the batches of many sinks into one device batch.
BATCH_LINES = 8192


class FilteredSink(Sink):
    def __init__(self, inner: Sink, service: AsyncFilterService,
                 stats: FilterStats):
        self._inner = inner
        self._service = service
        self._stats = stats
        self._closed = False
        self._batcher = FramedBatcher()
        # Held across match + write so two flushes of this file cannot
        # reorder its lines while a batch is in flight. Created at first
        # flush, inside the running loop.
        self._flush_lock: "asyncio.Lock | None" = None

    async def write(self, chunk: bytes) -> None:
        if self._batcher.feed(chunk) >= BATCH_LINES:
            await self._flush_pending()

    async def _flush_pending(self, final: bool = False) -> None:
        if self._flush_lock is None:
            self._flush_lock = asyncio.Lock()
        async with self._flush_lock:
            payload, offsets, n = self._batcher.take(final=final)
            if n == 0:
                return
            t0 = time.perf_counter()
            mask = await self._service.match_framed(payload, offsets)
            latency = time.perf_counter() - t0
            out = join_kept_framed(payload, offsets, mask)
            if out:
                await self._inner.write(out)
            self._stats.record_batch(
                n_lines=n, n_matched=int(np.count_nonzero(mask)),
                latency_s=latency)

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
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

    def sink_factory(self, job: StreamJob) -> Sink:
        return FilteredSink(FileSink(job.path), self.service, self.stats)

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


def make_pipeline(patterns: list[str], backend: str = "cuda",
                  ignore_case: bool = False,
                  exclude: list[str] | None = None,
                  device=None) -> FilterPipeline:
    """The --match/--exclude pipeline on the GPU engine. ``device=None``
    means ``"cuda"`` (raising where there is no card); tests pass
    ``"cpu"``."""
    if backend != "cuda":
        raise ValueError(f"unknown filter backend {backend!r}")
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter

    stats = FilterStats()
    log_filter = build_include_exclude(
        lambda pats: GpuEngineFilter(pats, ignore_case=ignore_case,
                                     device=device),
        patterns, exclude)
    return FilterPipeline(
        log_filter=log_filter,
        stats=stats,
        service=AsyncFilterService(log_filter, stats=stats),
    )
