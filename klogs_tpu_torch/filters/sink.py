"""FilteredSink and FilterPipeline: the write-gating stage.

Counterpart of ``klogs_tpu/filters/sink.py``. A FilteredSink sits where
a container's log bytes would be written: it frames chunks into lines,
asks the filter for a keep-mask once ``batch_lines`` lines are pending,
when the oldest pending line has waited ``deadline_s`` (checked at the
next write and by the pipeline's follow-mode deadline flusher), and at
close, and writes only kept lines, in the original order.
``make_pipeline`` builds the shared engine and the per-container sink
factory:

- ``backend="cuda"``: the GPU engine behind an AsyncFilterService,
  which coalesces every sink's batches (``BATCH_LINES`` = 8192);
- ``backend="cpu"``: the strongest host engine the set admits
  (filters/cpu.py ``best_host_filter``), which each sink calls directly,
  ``dispatch_framed`` then ``fetch_framed``, with no service and
  batches of ``CPU_BATCH_LINES`` = 1024, as the JAX sink does: the C
  scans run at millions of lines a second, so a service hop would only
  add latency. It never touches the card;
- ``remote`` or ``resolver``: no engine; the sinks ask filterd for their
  verdicts, through a RemoteFilterClient (``service/client.py``) for one
  endpoint or a ShardedFilterClient (``service/shard.py``) for a fleet;
  neither needs a card.

Each flush is a ``sink.flush`` span (a child of the chunk's
``fanout.read`` span, or a root under the deadline flusher and at
close), and the write of its kept lines a ``sink.write`` span (``bytes``
and, beyond the JAX span's attributes, ``lines``). A batch
the filter service could not filter (``Unavailable``: a remote
filterd's retries exhausted or its breaker open, every endpoint of a
fleet down, or a quota shed) takes
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
# The host engines' batch: each sink calls its engine directly.
CPU_BATCH_LINES = 1024
# How long a pending line may wait for its verdict in follow mode.
DEADLINE_S = 0.05


class FilteredSink(Sink):
    """``service`` None: the sink calls ``log_filter`` itself (the host
    engines' direct path)."""

    def __init__(self, inner: Sink, service: "FilterService | None",
                 stats: FilterStats, deadline_s: float = DEADLINE_S,
                 on_close: "Callable[[FilteredSink], None] | None" = None,
                 on_filter_error: str = "abort",
                 log_filter: "LogFilter | None" = None,
                 batch_lines: int = BATCH_LINES):
        if service is None and log_filter is None:
            raise ValueError("FilteredSink needs a service or a log_filter")
        self._inner = inner
        self._service = service
        self._filter = log_filter
        self._batch_lines = batch_lines
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
        if n >= self._batch_lines or (
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
        if self._service is None:
            # The host engines' direct path: their C scans release the
            # GIL and run at millions of lines a second, no service hop.
            mask = self._filter.fetch_framed(
                self._filter.dispatch_framed(payload, offsets))
        else:
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
    the server's set against. With the host engines ``service`` is None
    and each sink calls ``log_filter`` itself."""

    log_filter: "LogFilter | None"
    stats: FilterStats
    service: "FilterService | None"
    deadline_s: float = DEADLINE_S
    batch_lines: int = BATCH_LINES
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
                            on_filter_error=self.on_filter_error,
                            log_filter=self.log_filter,
                            batch_lines=self.batch_lines)
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
        engine, or close a remote client's channel, or release a host
        engine."""
        if self.service is not None:
            await self.service.aclose()
        elif self.log_filter is not None:
            self.log_filter.close()

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
        index = _indexed_engine(self.log_filter)
        if index is not None:
            term.info(
                "  indexed engine: %d groups %s, narrowing ratio %.3f "
                "(%d/%d cells), stage s sweep=%.3f group_scan=%.3f "
                "merge=%.3f",
                len(index.groups), index.engine_kinds,
                index.narrowing_ratio, index.candidate_cells,
                index.swept_cells, index.stage_s["sweep"],
                index.stage_s["group_scan"], index.stage_s["merge"])


def _indexed_engine(log_filter):
    """The IndexedFilter behind ``log_filter`` (the include side of an
    include/exclude pair first), or None."""
    from klogs_tpu_torch.filters.base import IncludeExcludeFilter
    from klogs_tpu_torch.filters.indexed import IndexedFilter

    stack = [log_filter]
    while stack:
        f = stack.pop(0)
        if isinstance(f, IndexedFilter):
            return f
        if isinstance(f, IncludeExcludeFilter):
            stack += [x for x in (f.include, f.exclude) if x is not None]
    return None


def make_pipeline(patterns: list[str], backend: str = "cuda",
                  ignore_case: bool = False,
                  exclude: list[str] | None = None,
                  device=None, registry=None,
                  remote: str | None = None,
                  on_filter_error: str = "abort",
                  shard_mode: str = "round-robin",
                  resolver: str | None = None,
                  kubeconfig: str | None = None) -> FilterPipeline:
    """The --match/--exclude pipeline: on the GPU engine for ``backend``
    ``"cuda"``, on the host engines for ``"cpu"`` (module docstring).
    ``device=None`` means ``"cuda"`` for the GPU engine (raising where
    there is no card); tests pass ``"cpu"``; the host engines do not
    read it. ``registry`` (an obs Registry) backs the stats for a
    /metrics sidecar or a --stats-json dump; None keeps them private.
    ``remote`` (HOST:PORT, or a comma-separated fleet) or ``resolver``
    (a ``--resolver`` spec) asks filterd instead of building an engine;
    ``on_filter_error`` is every sink's degrade action."""
    stats = FilterStats(registry=registry)
    if remote is not None or resolver is not None:
        return FilterPipeline(
            log_filter=None, stats=stats,
            service=_remote_service(patterns, ignore_case, exclude or [],
                                    remote, shard_mode, resolver,
                                    kubeconfig, registry),
            patterns=list(patterns), ignore_case=ignore_case,
            exclude=list(exclude or []), on_filter_error=on_filter_error)
    if backend == "cpu":
        from klogs_tpu_torch.filters.cpu import best_host_filter

        # The engines' families ride the include side only (feeding
        # both would count twice), as the stats do on the GPU path.
        made = []

        def host(pats):
            f = best_host_filter(
                pats, ignore_case=ignore_case,
                registry=stats.registry if not made else None)[0]
            made.append(f)
            return f

        return FilterPipeline(
            log_filter=build_include_exclude(host, patterns, exclude),
            stats=stats, service=None, batch_lines=CPU_BATCH_LINES,
            on_filter_error=on_filter_error)
    if backend != "cuda":
        raise ValueError(f"unknown filter backend {backend!r}")
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.parallel import mesh

    # Several cards: lines (data) x pattern shards over a mesh of them;
    # one card: the engine alone, with no OR across shards.
    devices = mesh.engine_devices(device)

    def engine(pats):
        if len(devices) < 2:
            return GpuEngineFilter(pats, ignore_case=ignore_case,
                                   device=device, stats=stats)
        return GpuEngineFilter(
            pats, ignore_case=ignore_case, stats=stats,
            engine=mesh.MeshEngine(pats, ignore_case=ignore_case,
                                   devices=devices))

    log_filter = build_include_exclude(engine, patterns, exclude)
    return FilterPipeline(
        log_filter=log_filter,
        stats=stats,
        service=AsyncFilterService(log_filter, stats=stats),
        on_filter_error=on_filter_error,
    )


def _remote_service(patterns: list[str], ignore_case: bool,
                    exclude: list[str], remote: "str | None",
                    shard_mode: str, resolver: "str | None",
                    kubeconfig: "str | None", registry):
    """The client of the filterd tier, configured from the environment
    (a --remote deployment is set up by its manifest):
    ``KLOGS_REMOTE_TIMEOUT_S`` bounds each attempt, ``KLOGS_REMOTE_TLS_CA``
    turns on TLS, ``_TLS_CERT``/``_TLS_KEY`` add mTLS and
    ``KLOGS_REMOTE_TOKEN_FILE`` bearer auth (a path, read again for each
    RPC). One endpoint and no resolver is the plain RemoteFilterClient;
    a list, or a resolver (whose snapshots replace the ``--remote``
    seed from the first poll), is the sharded tier, with
    ``KLOGS_HEDGE_S``, ``KLOGS_READYZ_INTERVAL_S`` and, in the client,
    ``KLOGS_RESOLVER_INTERVAL_S`` and ``KLOGS_WEIGHT_DECAY_S``. A bad
    value raises ServiceConfigError, one line from the CLI."""
    from klogs_tpu_torch.resilience import FAULTS
    from klogs_tpu_torch.service.client import (
        RemoteFilterClient,
        ServiceConfigError,
    )
    from klogs_tpu_torch.service.shard import (
        DEFAULT_HEDGE_S,
        DEFAULT_PROBE_INTERVAL_S,
        ShardedFilterClient,
        parse_endpoints,
        pattern_fingerprint,
    )
    from klogs_tpu_torch.utils.env import positive_float
    from klogs_tpu_torch.utils.env import read as env_read

    def knob(name: str, default: float) -> float:
        return positive_float(name, default, exc=ServiceConfigError)

    rpc_timeout_s = knob("KLOGS_REMOTE_TIMEOUT_S", 30.0)
    live_resolver = None
    if resolver is not None:
        from klogs_tpu_torch.service.resolver import make_resolver

        try:
            live_resolver = make_resolver(resolver, kubeconfig=kubeconfig)
        except ValueError as e:
            raise ServiceConfigError(str(e)) from None
    targets = parse_endpoints(remote) if remote is not None else []
    stray = FAULTS.armed_targets() - set(targets)
    if stray and live_resolver is None:
        # A clause aimed at an endpoint outside the fleet never fires:
        # say so, or a chaos run passes without the fault it was meant
        # to drive. (With a resolver the fleet is open-ended.)
        term.warning(
            "KLOGS_FAULTS targets %s not in the --remote list %s — "
            "those clauses will never fire",
            ", ".join(sorted(stray)), ",".join(targets))
    common = dict(
        tls_ca=env_read("KLOGS_REMOTE_TLS_CA"),
        tls_cert=env_read("KLOGS_REMOTE_TLS_CERT"),
        tls_key=env_read("KLOGS_REMOTE_TLS_KEY"),
        auth_token_file=env_read("KLOGS_REMOTE_TOKEN_FILE"),
        rpc_timeout_s=rpc_timeout_s,
        registry=registry)
    if len(targets) == 1 and live_resolver is None:
        return RemoteFilterClient(targets[0], **common)
    # A batch raises Unavailable, and so degrades per --on-filter-error,
    # only when every endpoint is down.
    return ShardedFilterClient(
        targets, shard_mode=shard_mode,
        fingerprint=pattern_fingerprint(patterns, exclude, ignore_case),
        hedge_s=knob("KLOGS_HEDGE_S", DEFAULT_HEDGE_S),
        probe_interval_s=knob("KLOGS_READYZ_INTERVAL_S",
                              DEFAULT_PROBE_INTERVAL_S),
        resolver=live_resolver, **common)
