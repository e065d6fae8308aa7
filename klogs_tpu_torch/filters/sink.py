"""FilteredSink and FilterPipeline: the write-gating stage.

Counterpart of ``klogs_tpu/filters/sink.py``. A FilteredSink sits where
a container's log bytes would be written: it frames chunks into lines,
asks the filter for a keep-mask once ``BATCH_LINES`` lines are pending,
when the oldest pending line has waited ``deadline_s`` (checked at the
next write and by the pipeline's follow-mode deadline flusher), and at
close, and writes only kept lines, in the original order.
``make_pipeline`` builds the shared engine, its AsyncFilterService and
the per-container sink factory; with ``remote`` it builds no engine and
the sinks ask a filterd for their verdicts through a
RemoteFilterClient (``service/client.py``), which needs no card.

Each flush is a ``sink.flush`` span (a child of the chunk's
``fanout.read`` span, or a root under the deadline flusher and at
close), and the write of its kept lines a ``sink.write`` span (``bytes``
and, beyond the JAX span's attributes, ``lines``). A batch
the filter service could not filter (``Unavailable``: a remote
filterd's retries exhausted or its breaker open) takes
``--on-filter-error``: ``pass`` writes it unfiltered, ``drop`` discards
it, ``abort`` (the default) ends the run with one line; each is counted
in ``klogs_filter_degraded_*{action}``, marked by a ``sink.degrade``
event and arms a flight-recorder dump. In follow mode the deadline
flusher escalates an ``abort``: it sets the run's stop event and
raises.
"""

import asyncio
import time
from dataclasses import dataclass
from dataclasses import field as dataclasses_field
from typing import TYPE_CHECKING, Callable

import numpy as np

from klogs_tpu_torch.filters.async_service import AsyncFilterService
from klogs_tpu_torch.filters.base import FilterStats, LogFilter, build_include_exclude
from klogs_tpu_torch.filters.framer import FramedBatcher, join_kept_framed
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience.policy import Unavailable
from klogs_tpu_torch.runtime.fanout import StreamJob
from klogs_tpu_torch.runtime.sink import FileSink, Sink
from klogs_tpu_torch.ui import term

if TYPE_CHECKING:
    from klogs_tpu_torch.service.client import RemoteFilterClient

    FilterService = AsyncFilterService | RemoteFilterClient

# Lines a sink gathers before it asks for their verdicts; the service
# coalesces the batches of many sinks into one device batch.
BATCH_LINES = 8192
# How long a pending line may wait for its verdict in follow mode.
DEADLINE_S = 0.05


class FilteredSink(Sink):
    def __init__(self, inner: Sink, service: "FilterService",
                 stats: FilterStats, deadline_s: float = DEADLINE_S,
                 on_close: "Callable[[FilteredSink], None] | None" = None,
                 on_filter_error: str = "abort"):
        self._inner = inner
        self._service = service
        self._stats = stats
        self._deadline_s = deadline_s
        self._on_close = on_close
        self._closed = False
        # What a batch the service cannot filter gets: pass | drop |
        # abort; and whether the degrade warning is out.
        self._on_filter_error = on_filter_error
        self._degrade_warned = False
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
            await self._degrade(e, n_lines=n, payload=payload)
            return
        self._note_recovered()
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

    async def _degrade(self, e: Unavailable, *, n_lines: int,
                       payload: bytes) -> None:
        """A batch the filter service could not filter, per
        ``--on-filter-error``: ``pass`` writes it unfiltered, ``drop``
        discards it, ``abort`` raises (the run ends with one line). The
        event rides the ``sink.flush`` span, and the flight recorder
        dumps the batch's story when its trace completes."""
        action = self._on_filter_error
        trace.TRACER.event("sink.degrade", action=action, error=str(e))
        trace.flight_trigger("filter-degrade", action=action, error=str(e))
        if action == "abort":
            raise e
        if not self._degrade_warned:
            self._degrade_warned = True
            term.warning(
                "filter service unavailable (%s); --on-filter-error=%s: "
                "%s lines until it recovers", e, action,
                "writing UNFILTERED" if action == "pass" else "DROPPING")
        if action == "pass" and payload:
            await self._inner.write(payload)
        self._stats.record_degraded(action, n_lines)

    def _note_recovered(self) -> None:
        # The bookend of the degrade warning.
        if self._degrade_warned:
            self._degrade_warned = False
            term.info("filter service recovered; filtering resumed")

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
    per-container sink. With a remote filterd ``log_filter`` is None
    (the engine lives there), ``service`` is the RemoteFilterClient, and
    ``patterns``/``ignore_case``/``exclude`` are what ``start`` checks
    the server's set against."""

    log_filter: "LogFilter | None"
    stats: FilterStats
    service: "FilterService"
    deadline_s: float = DEADLINE_S
    patterns: "list[str] | None" = None
    ignore_case: bool = False
    exclude: "list[str] | None" = None
    # --on-filter-error for every sink built here.
    on_filter_error: str = "abort"
    # Where kept lines land; None = a FileSink on job.path. ``-o
    # stdout|both`` injects console and tee factories.
    inner_factory: "Callable[[StreamJob], Sink] | None" = None
    _live_sinks: "set[FilteredSink]" = dataclasses_field(default_factory=set)

    def sink_factory(self, job: StreamJob) -> Sink:
        inner = (self.inner_factory(job) if self.inner_factory is not None
                 else FileSink(job.path))
        sink = FilteredSink(inner, self.service, self.stats,
                            deadline_s=self.deadline_s,
                            on_close=self._live_sinks.discard,
                            on_filter_error=self.on_filter_error)
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
        worker meets the fault at its next write. An ``Unavailable``
        (only ``--on-filter-error=abort`` lets one out of a sink) ends
        the run instead: the flusher sets ``stop`` and raises it, so an
        idle stream's batch is not dropped quietly."""
        while True:
            await asyncio.sleep(self.deadline_s / 2)
            results = await asyncio.gather(
                *[s.flush_if_stale() for s in list(self._live_sinks)],
                return_exceptions=True)
            for r in results:
                if isinstance(r, Unavailable):
                    term.error("filter service unavailable and "
                               "--on-filter-error=abort: stopping (%s)", r)
                    # No root span may finish after this: dump now.
                    trace.flight_trigger("abort-escalation", error=str(r))
                    trace.RECORDER.flush()
                    if stop is not None:
                        stop.set()
                    raise r
                if isinstance(r, Exception):
                    term.warning("deadline flush failed: %s", r)

    async def start(self) -> None:
        """Before any line flows: a remote service checks the server's
        pattern set against the collector's."""
        verify = getattr(self.service, "verify_patterns", None)
        if verify is not None and self.patterns is not None:
            await verify(self.patterns, self.ignore_case,
                         exclude=self.exclude or [])

    async def aclose(self) -> None:
        """Inside the loop: drain the in-flight batches and release the
        engine, or close a remote client's channel."""
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
                  device=None, registry=None,
                  remote: str | None = None,
                  on_filter_error: str = "abort") -> FilterPipeline:
    """The --match/--exclude pipeline on the GPU engine. ``device=None``
    means ``"cuda"`` (raising where there is no card); tests pass
    ``"cpu"``. ``registry`` (an obs Registry) backs the stats for a
    /metrics sidecar or a --stats-json dump; None keeps them private.
    ``remote`` (one HOST:PORT) asks a filterd instead of building an
    engine; ``on_filter_error`` is every sink's degrade action."""
    stats = FilterStats(registry=registry)
    if remote is not None:
        return FilterPipeline(
            log_filter=None, stats=stats,
            service=_remote_client(remote, registry),
            patterns=list(patterns), ignore_case=ignore_case,
            exclude=list(exclude or []), on_filter_error=on_filter_error)
    if backend != "cuda":
        raise ValueError(f"unknown filter backend {backend!r}")
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter

    log_filter = build_include_exclude(
        lambda pats: GpuEngineFilter(pats, ignore_case=ignore_case,
                                     device=device, stats=stats),
        patterns, exclude)
    return FilterPipeline(
        log_filter=log_filter,
        stats=stats,
        service=AsyncFilterService(log_filter, stats=stats),
        on_filter_error=on_filter_error,
    )


def _remote_client(remote: str, registry):
    """The client of one filterd endpoint, configured from the
    environment (a --remote deployment is set up by its manifest):
    ``KLOGS_REMOTE_TIMEOUT_S`` bounds each attempt, ``KLOGS_REMOTE_TLS_CA``
    turns on TLS, ``_TLS_CERT``/``_TLS_KEY`` add mTLS and
    ``KLOGS_REMOTE_TOKEN_FILE`` bearer auth (a path, read again for each
    RPC). A bad value raises ServiceConfigError, one line from the CLI.
    A list of endpoints (the sharded tier) is not ported yet."""
    from klogs_tpu_torch.resilience import FAULTS
    from klogs_tpu_torch.service.client import (
        REMOTE_LIST_ERROR,
        RemoteFilterClient,
        ServiceConfigError,
        validate_target,
    )
    from klogs_tpu_torch.utils.env import positive_float
    from klogs_tpu_torch.utils.env import read as env_read

    target = remote.strip()
    if "," in target:
        raise ServiceConfigError(REMOTE_LIST_ERROR)
    validate_target(target)
    rpc_timeout_s = positive_float("KLOGS_REMOTE_TIMEOUT_S", 30.0,
                                   exc=ServiceConfigError)
    stray = FAULTS.armed_targets() - {target}
    if stray:
        # A clause aimed at another endpoint never fires: say so, or a
        # chaos run passes without the fault it was meant to drive.
        term.warning(
            "KLOGS_FAULTS targets %s not in the --remote list %s — "
            "those clauses will never fire",
            ", ".join(sorted(stray)), target)
    return RemoteFilterClient(
        target,
        tls_ca=env_read("KLOGS_REMOTE_TLS_CA"),
        tls_cert=env_read("KLOGS_REMOTE_TLS_CERT"),
        tls_key=env_read("KLOGS_REMOTE_TLS_KEY"),
        auth_token_file=env_read("KLOGS_REMOTE_TOKEN_FILE"),
        rpc_timeout_s=rpc_timeout_s,
        registry=registry)

