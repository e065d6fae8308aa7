"""Concurrent per-container log acquisition.

Counterpart of ``klogs_tpu/runtime/fanout.py``: one worker per (pod,
container), every log file created (truncated) before any worker
starts, a bound on concurrent stream opens (the reference's apiserver
burst of 100), and per-stream error isolation (one bad container never
ends the run).

Follow mode: a stream that ends while still wanted is reopened under
the shared ``RetryPolicy`` with a server-side ``since`` covering the
gap; ``run(..., stop=)`` tears down by closing every stream, after
which the workers flush and close their sinks; ``plan_new`` re-polls
the selection (``--watch-new``) and spawns workers for new containers.

Workers open streams through the source contract (``sources/base.py``):
a cluster backend is adapted by ``ClusterSource``, and file, archive
and socket sources get the same sinks, reconnects and error isolation.
A job planned from a source carries its ``SourceRef`` (group and unit
stand for pod and container); an ``ephemeral`` ref (a socket peer) ends
at its EOF, with no reconnect and no "premature end" warning.

With a registry (``--metrics-port``/``--stats-json``) the runner counts
into the ``klogs_fanout_*`` families and ``klogs_retry_attempts_total``
(site ``fanout``); each chunk's write is a ``fanout.read`` span (the
root of the batch's trace), and ``run`` registers the profiler's
``fanout.active_streams`` probe.
"""

import asyncio
import os
import re
import time
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Callable

from klogs_tpu_torch.cluster.backend import ClusterBackend
from klogs_tpu_torch.cluster.types import LogOptions, PodInfo
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience.policy import RetryPolicy
from klogs_tpu_torch.runtime.sink import FileSink, Sink, SinkError
from klogs_tpu_torch.sources.base import Source, SourceError, SourceRef
from klogs_tpu_torch.sources.cluster import ClusterSource
from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.naming import log_file_name

# Bounds concurrent stream opens (the reference's rest config Burst).
DEFAULT_OPEN_BURST = 100

# Follow-mode reconnection: the default policy grants this many
# reconnects; a connection that delivered data and lived
# RECONNECT_HEALTHY_S resets the budget. The backoff knobs are read at
# decision time (tests patch them).
DEFAULT_MAX_RECONNECTS = 5
RECONNECT_HEALTHY_S = 5.0
_BACKOFF_BASE_S = 0.5
_BACKOFF_MAX_S = 10.0

# A sink write blocking this long counts as a backpressure stall (the
# filter, file or console is the bottleneck, not the stream).
STALL_THRESHOLD_S = 0.05


@dataclass
class StreamJob:
    pod: str
    container: str
    init: bool
    path: str
    # The ref a source's job was planned from; None = a pod's identity.
    ref: "SourceRef | None" = None


@dataclass
class StreamResult:
    job: StreamJob
    bytes_written: int = 0
    error: str | None = None
    premature_end: bool = False  # stream ended while follow was requested


SinkFactory = Callable[[StreamJob], Sink]


def plan_jobs(
    pods: list[PodInfo], log_path: str, include_init: bool,
    container_re: "re.Pattern | None" = None,
    exclude_container_re: "re.Pattern | None" = None,
) -> list[StreamJob]:
    """Jobs in the reference's file-creation order: per pod, init
    containers first (with -i), then regular ones. A (pod, container)
    pair selected twice (several -l selectors) streams once.
    ``container_re``/``exclude_container_re`` (-c/-E) keep containers
    whose name re.search-matches the include and not the exclude."""
    jobs = []
    seen: set[tuple[str, str, bool]] = set()

    def want(name: str) -> bool:
        if container_re is not None and not container_re.search(name):
            return False
        return (exclude_container_re is None
                or not exclude_container_re.search(name))

    for pod in pods:
        groups = ([(c, True) for c in pod.init_containers] if include_init
                  else []) + [(c, False) for c in pod.containers]
        for c, init in groups:
            key = (pod.name, c.name, init)
            if key not in seen and want(c.name):
                seen.add(key)
                jobs.append(StreamJob(pod.name, c.name, init, os.path.join(
                    log_path, log_file_name(pod.name, c.name))))
    return jobs


def plan_source_jobs(refs: "list[SourceRef]",
                     log_path: str) -> list[StreamJob]:
    """plan_jobs for a source: one job per (group, unit), in the refs'
    order, group and unit naming the output file as pod and container
    do."""
    jobs = []
    seen: set[tuple[str, str]] = set()
    for ref in refs:
        key = (ref.group, ref.unit)
        if key in seen:
            continue
        seen.add(key)
        jobs.append(StreamJob(
            ref.group, ref.unit, False,
            os.path.join(log_path, log_file_name(ref.group, ref.unit)),
            ref=ref))
    return jobs


class FanoutRunner:
    def __init__(self, backend: "ClusterBackend | None", namespace: str,
                 log_opts: LogOptions,
                 sink_factory: SinkFactory | None = None,
                 open_burst: int = DEFAULT_OPEN_BURST,
                 max_reconnects: int = DEFAULT_MAX_RECONNECTS,
                 create_files: bool = True,
                 registry=None,
                 source: "Source | None" = None):
        if source is None:
            if backend is None:
                raise ValueError("FanoutRunner needs a backend or a source")
            source = ClusterSource(backend, namespace)
        self.source = source
        self.log_opts = log_opts
        self.sink_factory = sink_factory or (lambda job: FileSink(job.path))
        self.max_reconnects = max_reconnects
        # -o stdout: job paths stay identities, no file is touched.
        self.create_files = create_files
        self._open_burst = open_burst
        # asyncio primitives are created on first use, on the running
        # loop.
        self._open_sem: "asyncio.Semaphore | None" = None
        self._stop_event: "asyncio.Event | None" = None
        self._streams: list = []
        self._stopping = False
        self._m = None
        if registry is not None:
            self._m = {
                "active": registry.family("klogs_fanout_active_streams"),
                "bytes": registry.family("klogs_fanout_stream_bytes_total"),
                "reconnects": registry.family(
                    "klogs_fanout_reconnects_total"),
                "errors": registry.family(
                    "klogs_fanout_stream_errors_total"),
                "stalls": registry.family(
                    "klogs_fanout_backpressure_stalls_total"),
                "retries": registry.family(
                    "klogs_retry_attempts_total").labels(site="fanout"),
            }

    def _stop_ev(self) -> asyncio.Event:
        if self._stop_event is None:
            self._stop_event = asyncio.Event()
        return self._stop_event

    def _open_gate(self) -> asyncio.Semaphore:
        if self._open_sem is None:
            self._open_sem = asyncio.Semaphore(self._open_burst)
        return self._open_sem

    def _reconnect_opts(self, job: StreamJob, last_data: float) -> LogOptions:
        """A reconnect's options: since = the time since the last chunk
        (+1 s overlap), or a ``since_time`` later than that cutoff (the
        stricter bound), no tail (it would re-dump history), follow and
        timestamps kept."""
        gap_s = max(1, int(time.monotonic() - last_data) + 1)
        since_time = None
        if self.log_opts.since_time is not None:
            try:
                bound = datetime.fromisoformat(
                    self.log_opts.since_time.replace("Z", "+00:00"))
                if bound.tzinfo is None:
                    bound = bound.replace(tzinfo=timezone.utc)
                cutoff = datetime.now(timezone.utc) - timedelta(seconds=gap_s)
                if bound > cutoff:
                    since_time = self.log_opts.since_time
            except ValueError:
                pass  # an unparseable bound: the gap cutoff
        return LogOptions(
            since_seconds=None if since_time else gap_s,
            tail_lines=None, follow=True, container=job.container,
            since_time=since_time, timestamps=self.log_opts.timestamps)

    async def _worker(self, job: StreamJob) -> StreamResult:
        result = StreamResult(job=job)
        opts = LogOptions(
            since_seconds=self.log_opts.since_seconds,
            tail_lines=self.log_opts.tail_lines,
            follow=self.log_opts.follow, container=job.container,
            previous=self.log_opts.previous,
            timestamps=self.log_opts.timestamps,
            since_time=self.log_opts.since_time)
        sink = self.sink_factory(job)
        # The labeled children, looked up once rather than per chunk.
        m_bytes = (self._m["bytes"].labels(pod=job.pod,
                                           container=job.container)
                   if self._m is not None else None)
        attempt = 0
        # When data last arrived, kept ACROSS reconnects: an unproductive
        # reconnect must not advance it, or the gap would be skipped.
        last_data: float | None = None
        ref = job.ref or SourceRef(kind="pod", group=job.pod,
                                   unit=job.container, target=job.pod)
        try:
            while True:
                try:
                    async with self._open_gate():
                        stream = await self.source.open_stream(ref, opts)
                except SourceError as e:
                    if await self._should_reconnect(job, attempt, e):
                        attempt += 1
                        continue
                    term.error("Error getting logs for container %s\n%s",
                               job.container, e)
                    result.error = str(e)
                    return result

                if self._stopping:
                    # Opened after stop(): close it here, or run() hangs.
                    await stream.close()
                    return result
                self._streams.append(stream)
                if self._m is not None:
                    self._m["active"].inc()
                opened_at = time.monotonic()
                if last_data is None:
                    last_data = opened_at
                got_data = False
                stream_err: SourceError | None = None
                sink_err: SinkError | None = None
                # Each chunk's write is the root of its batch's trace (a
                # no-op singleton when sampling is off).
                tr = trace.TRACER
                try:
                    async for chunk in stream:
                        got_data = True
                        last_data = time.monotonic()
                        if m_bytes is not None:
                            m_bytes.inc(len(chunk))
                        with tr.span("fanout.read", pod=job.pod,
                                     container=job.container,
                                     bytes=len(chunk)):
                            await sink.write(chunk)
                        if (m_bytes is not None and time.monotonic()
                                - last_data >= STALL_THRESHOLD_S):
                            self._m["stalls"].inc()
                except SourceError as e:
                    stream_err = e
                except SinkError as e:
                    sink_err = e
                finally:
                    await stream.close()
                    try:
                        self._streams.remove(stream)
                        if self._m is not None:
                            self._m["active"].dec()
                    except ValueError:
                        pass

                if sink_err is not None:
                    # A dead sink: reconnecting would loop back into the
                    # same failure.
                    term.error("Sink failed for container %s\n%s",
                               job.container, sink_err)
                    result.error = str(sink_err)
                    return result

                if ref.ephemeral:
                    # A socket peer: its EOF is the end of its stream,
                    # and there is nothing to reconnect to.
                    if stream_err is not None and not self._stopping:
                        term.error("Error reading logs for container %s\n%s",
                                   job.container, stream_err)
                        result.error = str(stream_err)
                    return result

                if not self.log_opts.follow or self._stopping:
                    if stream_err is not None and not self._stopping:
                        term.error("Error reading logs for container %s\n%s",
                                   job.container, stream_err)
                        result.error = str(stream_err)
                    return result

                # A follow stream ended while still wanted.
                if (got_data and time.monotonic() - opened_at
                        >= RECONNECT_HEALTHY_S):
                    attempt = 0
                if not await self._should_reconnect(job, attempt, stream_err):
                    result.premature_end = True
                    if stream_err is not None:
                        result.error = str(stream_err)
                    term.warning("Streaming logs ended prematurely for "
                                 "Pod: %s, Container: %s",
                                 job.pod, job.container)
                    return result
                attempt += 1
                opts = self._reconnect_opts(job, last_data)
        finally:
            try:
                await sink.close()
            except SinkError as e:
                if result.error is None:
                    term.error("Sink close failed for container %s\n%s",
                               job.container, e)
                    result.error = str(e)
            result.bytes_written = sink.bytes_written
            if self._m is not None and result.error is not None:
                self._m["errors"].inc()

    def _reconnect_policy(self) -> RetryPolicy:
        """max_reconnects retries (max_attempts counts the first open
        too) with the module's backoff knobs, read at decision time."""
        return RetryPolicy(max_attempts=self.max_reconnects + 1,
                           base_s=_BACKOFF_BASE_S, max_s=_BACKOFF_MAX_S,
                           jitter=0.0)

    async def _should_reconnect(self, job: StreamJob, attempt: int,
                                err: "SourceError | None") -> bool:
        """Follow mode's reconnect decision; sleeps the policy's backoff
        (stop-aware) when it says yes. ``attempt`` counts the reconnects
        already spent."""
        if not self.log_opts.follow or self._stopping:
            return False
        policy = self._reconnect_policy()
        if not policy.retries_left(attempt):
            return False
        delay = policy.delay_s(attempt)
        term.warning(
            "Stream for %s/%s ended (%s); reconnecting in %.1fs "
            "(attempt %d/%d)", job.pod, job.container,
            err if err else "EOF", delay, attempt + 1,
            policy.max_attempts - 1)
        if not await policy.wait(delay, self._stop_ev()):
            return False  # stop fired during the backoff
        if not self._stopping and self._m is not None:
            self._m["reconnects"].labels(
                pod=job.pod, container=job.container).inc()
            self._m["retries"].inc()
        return not self._stopping

    def _create_file(self, job: StreamJob) -> None:
        if not self.create_files:
            return
        os.makedirs(os.path.dirname(job.path) or ".", exist_ok=True)
        open(job.path, "wb").close()

    def _create_all_files(self, jobs: list[StreamJob]) -> None:
        for job in jobs:
            self._create_file(job)

    async def _spawn(self, job: StreamJob, tasks: list) -> None:
        # File creation is disk I/O: off the loop, which is streaming.
        await asyncio.to_thread(self._create_file, job)
        tasks.append(asyncio.create_task(self._worker(job)))

    async def _discover_loop(self, plan_new, interval_s: float,
                             seen: set, tasks: list) -> None:
        """``--watch-new``: every ``interval_s`` re-plan and spawn
        workers for unseen (pod, container, init) keys. A failed poll
        warns and the polling goes on."""
        while not self._stopping:
            try:
                await asyncio.wait_for(self._stop_ev().wait(),
                                       timeout=interval_s)
                return  # stop fired
            except asyncio.TimeoutError:
                pass
            try:
                jobs = await plan_new()
                if self._stopping:
                    return
                fresh = [j for j in jobs
                         if (j.pod, j.container, j.init) not in seen]
                if not fresh:
                    continue
                term.info("Discovered %d new container stream(s): %s",
                          len(fresh),
                          ", ".join(f"{j.pod}/{j.container}"
                                    for j in fresh[:6])
                          + ("…" if len(fresh) > 6 else ""))
                for j in fresh:
                    # Seen only after a spawn that worked: a failed file
                    # creation leaves the job for the next poll.
                    await self._spawn(j, tasks)
                    seen.add((j.pod, j.container, j.init))
            except Exception as e:
                term.warning("pod discovery poll failed (%s); retrying", e)

    async def run(self, jobs: list[StreamJob],
                  stop: asyncio.Event | None = None, plan_new=None,
                  discover_interval_s: float = 5.0) -> list[StreamResult]:
        """Create every log file, then run the workers to completion; if
        ``stop`` fires first, close every stream (the workers then flush
        their sinks) and return. ``plan_new`` (async () ->
        list[StreamJob], follow mode only) is re-polled every
        ``discover_interval_s``; with it the run ends only on ``stop``."""
        # Off the loop: truncating hundreds of files is disk I/O.
        await asyncio.to_thread(self._create_all_files, jobs)
        # The profiler's open-stream count, dropped with the run.
        from klogs_tpu_torch.obs.profiler import PROFILER

        def _streams_probe() -> float:
            return float(len(self._streams))

        PROFILER.add_probe("fanout.active_streams", _streams_probe)
        tasks: list[asyncio.Task] = [
            asyncio.create_task(self._worker(j)) for j in jobs]
        seen = {(j.pod, j.container, j.init) for j in jobs}
        poller = (asyncio.create_task(
                      self._discover_loop(plan_new, discover_interval_s,
                                          seen, tasks))
                  if plan_new is not None and self.log_opts.follow else None)
        stop_task = (asyncio.create_task(stop.wait()) if stop is not None
                     else None)
        try:
            try:
                while True:
                    waiters = {t for t in tasks if not t.done()}
                    if not waiters and poller is None:
                        break  # the static plan is drained
                    if stop_task is not None:
                        waiters.add(stop_task)
                    if poller is not None:
                        waiters.add(poller)
                    done, _ = await asyncio.wait(
                        waiters, return_when=asyncio.FIRST_COMPLETED)
                    if stop_task is not None and stop_task in done:
                        await self.stop()
                        break
                    if poller is not None and poller.done():
                        exc = poller.exception()
                        if exc is not None:
                            term.warning(
                                "pod discovery stopped unexpectedly: %s", exc)
                        poller = None
            finally:
                if poller is not None:
                    self._stop_ev().set()
                    try:
                        await poller
                    except Exception as e:
                        term.warning(
                            "pod discovery stopped unexpectedly: %s", e)
                if stop_task is not None:
                    stop_task.cancel()
                PROFILER.remove_probe("fanout.active_streams",
                                      _streams_probe)
            return await asyncio.gather(*tasks)
        except BaseException:
            # A worker raised (or run() was cancelled): close every other
            # stream and let the workers drain before the error surfaces.
            await self.stop()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise

    async def stop(self) -> None:
        """Close every live stream; the workers then drain and flush
        their sinks."""
        self._stopping = True
        self._stop_ev().set()
        for s in list(self._streams):
            await s.close()
