"""AsyncFilterService: pipelined, coalescing batch execution for the GPU
engine.

Counterpart of ``klogs_tpu/filters/async_service.py``. Concurrent
``match``/``match_framed`` calls from many sinks coalesce into large
device batches: callers' framed batches are concatenated, the engine's
``dispatch_framed`` enqueues the device work on the event-loop thread
(cheap: host packing, copies and kernel launches), and its
``fetch_framed`` waits for the verdicts on a small thread pool, so
several batches are in flight at once. Each caller's future gets its
slice of the verdicts. In-flight batches are bounded (backpressure).

Per-sink write ordering is the sink's concern (FilteredSink holds its
flush lock across the await).

With a ``FilterStats`` the coalescer reports into its registry
(``klogs_coalescer_*``) and registers the profiler's probes
(``coalescer.queue_depth``, ``coalescer.pending_lines``,
``device.in_flight_used``, ``device.fetch_queue``), dropped at close.
``coalescer.queue_depth`` counts every caller queued ahead of the card:
those still coalescing and those whose group waits for an in-flight
slot. (The JAX package's counts the first only; under many callers,
whose groups fill at once and then wait for a slot, the ``ops/tune.py``
controller's "slots full with callers queued" then shows only while a
leftover caller happens to be coalescing.)
Each group is a ``coalescer.dispatch`` span, parented under its first
traced caller; ``device.fetch`` wraps the await of the verdicts (the
executor thread does not inherit the trace context): the host's wait,
around the card's own time, which the engine records as ``card.batch``
(``filters/gpu.py``). The fetch threads' time in the engine's fetch
and their CPU time in it (``klogs_fetch_wait_seconds_total``,
``klogs_fetch_cpu_seconds_total``) are counted with a ``FilterStats``:
four clock reads a batch, on the executor thread.

``KLOGS_MAX_IN_FLIGHT``, ``KLOGS_FETCH_WORKERS`` and
``KLOGS_COALESCE_LINES`` set the defaults of the constructor's
arguments, read at import as in the JAX package (a malformed value warns
and the default is used). ``apply_tuning`` moves ``coalesce_lines`` and
``max_in_flight`` live: the ``KLOGS_TUNE=auto`` controller
(``ops/tune.py``) drives it.
"""

import asyncio
import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from klogs_tpu_torch.filters.base import FilterStats, LogFilter, frame_lines
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.utils.env import warn_positive_int as _env_int

# Each fetch holds a worker thread for a whole device round trip, so
# batches/s is capped at workers / round trip; the in-flight depth
# bounds the batches enqueued on the card at once.
DEFAULT_MAX_IN_FLIGHT = _env_int("KLOGS_MAX_IN_FLIGHT", 16)
DEFAULT_FETCH_WORKERS = _env_int("KLOGS_FETCH_WORKERS", 8)
DEFAULT_COALESCE_LINES = _env_int("KLOGS_COALESCE_LINES", 8192)
DEFAULT_COALESCE_DELAY_S = 0.005

# Offsets ride int32: a coalesced group whose combined payload passes
# this is split, or the shifted member offsets would wrap negative.
GROUP_PAYLOAD_LIMIT = 2**31 - 1


class AsyncFilterService:
    """``executor`` and ``in_flight`` (a ThreadPoolExecutor and an
    asyncio.Semaphore) share one fetch pool and one in-flight budget
    among services: the multi-set registry runs every set's service over
    the same two, as the process owns one card. Without them the service
    makes its own; it shuts down only a pool it made. A service over a
    shared ``in_flight`` budget is not ``tunable``: its depth belongs to
    the registry."""

    def __init__(self, log_filter: LogFilter,
                 max_in_flight: int = DEFAULT_MAX_IN_FLIGHT,
                 fetch_workers: int = DEFAULT_FETCH_WORKERS,
                 coalesce_lines: int = DEFAULT_COALESCE_LINES,
                 coalesce_delay_s: float = DEFAULT_COALESCE_DELAY_S,
                 stats: FilterStats | None = None,
                 executor: "ThreadPoolExecutor | None" = None,
                 in_flight: "asyncio.Semaphore | None" = None):
        self._filter = log_filter
        self._stats = stats
        self._m = None
        if stats is not None:
            r = stats.registry
            self._m = {
                "depth": r.family("klogs_coalescer_queue_depth"),
                "pending": r.family("klogs_coalescer_pending_lines"),
                "groups": r.family("klogs_coalescer_groups_total"),
                "members": r.family("klogs_coalescer_group_members"),
                "lines": r.family("klogs_coalescer_group_lines"),
                "splits": r.family("klogs_coalescer_group_splits_total"),
                "bp_wait": r.family(
                    "klogs_coalescer_backpressure_wait_seconds"),
                "dispatch": r.family("klogs_coalescer_dispatch_seconds"),
                "fetch_wait": r.family("klogs_fetch_wait_seconds_total"),
                "fetch_cpu": r.family("klogs_fetch_cpu_seconds_total"),
            }
        # An own semaphore is made at first dispatch, inside the loop.
        self._sem: "asyncio.Semaphore | None" = in_flight
        self._own_sem = in_flight is None
        self._max_in_flight = max_in_flight
        self._own_pool = executor is None
        self._pool = executor if executor is not None else ThreadPoolExecutor(
            max_workers=fetch_workers, thread_name_prefix="klogs-fetch")
        self._coalesce_lines = coalesce_lines
        self._coalesce_delay_s = coalesce_delay_s
        # The profiler's probes, read at its ticks (host counters only);
        # services over a shared pool overwrite each other's, which read
        # the same budget.
        self._probes: "dict[str, object]" = {}
        if stats is not None:
            from klogs_tpu_torch.obs.profiler import PROFILER

            self._probes = {
                "coalescer.queue_depth":
                    lambda: float(len(self._pending) + self._slot_waiters),
                "coalescer.pending_lines":
                    lambda: float(self._pending_lines),
                "device.in_flight_used": self._in_flight_used,
                "device.fetch_queue": self._fetch_queue_depth,
            }
            for name, fn in self._probes.items():
                PROFILER.add_probe(name, fn)
        # (payload, offsets, n_lines, future, enqueue_time, trace
        # context) per caller.
        self._pending: list[tuple] = []
        self._pending_lines = 0
        # Callers whose group waits for an in-flight slot.
        self._slot_waiters = 0
        self._kick_handle: asyncio.TimerHandle | None = None
        self._closed = False
        # Strong references: the loop holds tasks weakly.
        self._tasks: set[asyncio.Task] = set()
        self.batches_dispatched = 0

    @property
    def coalesce_lines(self) -> int:
        return self._coalesce_lines

    @property
    def max_in_flight(self) -> int:
        return self._max_in_flight

    @property
    def tunable(self) -> bool:
        """Whether ``apply_tuning`` may move this service's depth: not
        over a shared in-flight budget."""
        return self._own_sem

    def apply_tuning(self, coalesce_lines: "int | None" = None,
                     max_in_flight: "int | None" = None) -> None:
        """Adopt a new operating point (the ``ops/tune.py`` controller,
        which bounds the values). ``coalesce_lines`` applies from the
        next enqueue. ``max_in_flight`` resizes the semaphore live: an
        increase releases permits at once, a decrease absorbs permits in
        a background task as batches retire; no dispatched batch is
        cancelled, and ``aclose`` gathers the task."""
        if not self._own_sem:
            raise RuntimeError(
                "AsyncFilterService over a shared in-flight budget cannot "
                "be tuned")
        if coalesce_lines is not None:
            self._coalesce_lines = int(coalesce_lines)
        if max_in_flight is None:
            return
        new = int(max_in_flight)
        delta = new - self._max_in_flight
        if delta == 0:
            return
        self._max_in_flight = new
        sem = self._sem
        if sem is None:
            return  # the first dispatch makes it at the new depth
        if delta > 0:
            for _ in range(delta):
                sem.release()
            return

        async def _absorb(n: int = -delta) -> None:
            # Acquire and hold: the depth shrinks for good. Permits come
            # back as groups retire, so this settles once the pipeline
            # has drained to the new depth; the semaphore dies with the
            # service, so a cancelled absorb strands nothing.
            for _ in range(n):
                await sem.acquire()

        task = asyncio.get_running_loop().create_task(_absorb())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _in_flight_used(self) -> float:
        """Occupied in-flight slots (0 before the first dispatch)."""
        sem = self._sem
        if sem is None:
            return 0.0
        return float(max(0, self._max_in_flight - sem._value))

    def _fetch_queue_depth(self) -> float:
        """Fetches waiting for a free executor thread."""
        q = getattr(self._pool, "_work_queue", None)
        return float(q.qsize()) if q is not None else 0.0

    def _drop_probes(self) -> None:
        if self._probes:
            from klogs_tpu_torch.obs.profiler import PROFILER

            for name, fn in self._probes.items():
                PROFILER.remove_probe(name, fn)
            self._probes = {}

    async def match(self, lines: list[bytes]) -> list[bool]:
        """One verdict per line; concurrent calls share device batches."""
        if not lines:
            return []
        payload, offsets, _ = frame_lines(lines)
        arr = await self._enqueue(payload, offsets, len(lines))
        return arr.tolist()

    async def match_framed(self, payload: bytes, offsets) -> np.ndarray:
        """Framed entry (offsets int32[n+1]); resolves with a bool array."""
        n = len(offsets) - 1
        if n <= 0:
            if n < 0:
                raise ValueError("framed batch: empty offsets array")
            return np.zeros(0, dtype=bool)
        return await self._enqueue(payload, offsets, n)

    async def _enqueue(self, payload: bytes, offsets, n: int):
        if self._closed:
            raise RuntimeError("AsyncFilterService is closed")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        # The caller's trace context rides its entry: the group's
        # dispatch span parents under the first traced member.
        ctx = trace.TRACER.current_context()
        if ctx is not None:
            trace.TRACER.event("coalescer.enqueue", lines=n,
                               queue_depth=len(self._pending))
        self._pending.append((payload, offsets, n, fut, time.perf_counter(),
                              ctx))
        self._pending_lines += n
        if self._m is not None:
            self._m["depth"].set(len(self._pending))
            self._m["pending"].set(self._pending_lines)
        if self._pending_lines >= self._coalesce_lines:
            self._kick(loop)
        elif self._kick_handle is None:
            self._kick_handle = loop.call_later(
                self._coalesce_delay_s, self._kick, loop)
        return await fut

    def _kick(self, loop) -> None:
        if self._kick_handle is not None:
            self._kick_handle.cancel()
            self._kick_handle = None
        if not self._pending:
            return
        group, self._pending = self._pending, []
        self._pending_lines = 0
        if self._m is not None:
            self._m["depth"].set(0)
            self._m["pending"].set(0)
        task = loop.create_task(self._run_group(group))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_group(self, group) -> None:
        if len(group) > 1 and (
                sum(len(e[0]) for e in group) > GROUP_PAYLOAD_LIMIT):
            subs, sub, size = [], [], 0
            for e in group:
                if sub and size + len(e[0]) > GROUP_PAYLOAD_LIMIT:
                    subs.append(sub)
                    sub, size = [], 0
                sub.append(e)
                size += len(e[0])
            subs.append(sub)
            if self._m is not None:
                self._m["splits"].inc(len(subs) - 1)
            for sub in subs:
                await self._run_group(sub)
            return
        if len(group) == 1:
            payload, offsets = group[0][0], group[0][1]
        else:
            payload = b"".join(e[0] for e in group)
            parts, base = [], 0
            for e in group:
                parts.append(np.asarray(e[1][:-1], dtype=np.int64) + base)
                base += len(e[0])
            parts.append(np.asarray([base], dtype=np.int64))
            offsets = np.concatenate(parts).astype(np.int32)
        loop = asyncio.get_running_loop()
        # One trace carries the group's story: the first member with a
        # sampled context parents the span, the others are linked as
        # events.
        parent = next(
            (e[5] for e in group if e[5] is not None and e[5].sampled),
            next((e[5] for e in group if e[5] is not None), None))
        with trace.TRACER.span("coalescer.dispatch", parent=parent,
                               members=len(group),
                               lines=len(offsets) - 1) as sp:
            for e in group:
                ctx = e[5]
                if (ctx is not None and ctx is not parent
                        and getattr(ctx, "sampled", False)):
                    sp.add_event("coalescer.link",
                                 trace_id=f"{ctx.trace_id:032x}",
                                 span_id=f"{ctx.span_id:016x}")
            try:
                t_sem = time.perf_counter()
                if self._sem is None:
                    self._sem = asyncio.Semaphore(self._max_in_flight)
                async with self._slot(len(group)):
                    t_dispatch = time.perf_counter()
                    if self._stats is not None:
                        self._stats.mark_batch_started(t_dispatch)
                        for e in group:
                            self._stats.record_queue_wait(t_dispatch - e[4])
                    if self._m is not None:
                        self._m["bp_wait"].observe(t_dispatch - t_sem)
                        self._m["groups"].inc()
                        self._m["members"].observe(len(group))
                        self._m["lines"].observe(len(offsets) - 1)
                    sp.add_event("coalescer.dispatching",
                                 backpressure_wait_s=t_dispatch - t_sem)
                    handle = self._filter.dispatch_framed(payload, offsets)
                    self.batches_dispatched += 1
                    if self._m is not None:
                        self._m["dispatch"].observe(
                            time.perf_counter() - t_dispatch)
                    with trace.TRACER.span("device.fetch"):
                        verdicts = await loop.run_in_executor(
                            self._pool, self._fetch, handle)
                    if self._stats is not None:
                        self._stats.record_device_batch(
                            time.perf_counter() - t_dispatch)
            except Exception as e:
                # The error goes to every member's future (and from there
                # to its sink); the span says it failed.
                sp.set_status("error")
                sp.set_attr("error", f"{type(e).__name__}: {e}")
                for _, _, _, fut, *_ in group:
                    if not fut.done():
                        fut.set_exception(e)
                return
        off = 0
        for _, _, n, fut, *_ in group:
            if not fut.done():
                fut.set_result(verdicts[off:off + n])
            off += n

    def _fetch(self, handle) -> np.ndarray:
        """The engine's fetch, on an executor thread; counted (its wait,
        and the thread's CPU time in it) with a ``FilterStats``."""
        if self._m is None:
            return self._filter.fetch_framed(handle)
        t0, cpu0 = time.perf_counter(), time.thread_time()
        try:
            return self._filter.fetch_framed(handle)
        finally:
            self._m["fetch_cpu"].inc(time.thread_time() - cpu0)
            self._m["fetch_wait"].inc(time.perf_counter() - t0)

    @contextlib.asynccontextmanager
    async def _slot(self, n_callers: int):
        """An in-flight slot for a group of ``n_callers``, who count as
        queued (``coalescer.queue_depth``) while they wait for it."""
        self._slot_waiters += n_callers
        try:
            await self._sem.acquire()
        finally:
            self._slot_waiters -= n_callers
        try:
            yield
        finally:
            self._sem.release()

    async def aclose(self) -> None:
        """Dispatch any coalescing lines, drain in-flight batches, then
        release the pool (if this service made it) and the engine."""
        self._closed = True
        self._drop_probes()
        if self._pending:
            self._kick(asyncio.get_running_loop())
        elif self._kick_handle is not None:
            self._kick_handle.cancel()
            self._kick_handle = None
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        if self._own_pool:
            await asyncio.to_thread(self._pool.shutdown)
        self._filter.close()
