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
"""

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from klogs_tpu_torch.filters.base import FilterStats, LogFilter, frame_lines

MAX_IN_FLIGHT = 16
FETCH_WORKERS = 8
COALESCE_LINES = 8192
COALESCE_DELAY_S = 0.005

# Offsets ride int32: a coalesced group whose combined payload passes
# this is split, or the shifted member offsets would wrap negative.
GROUP_PAYLOAD_LIMIT = 2**31 - 1


class AsyncFilterService:
    def __init__(self, log_filter: LogFilter,
                 stats: FilterStats | None = None):
        self._filter = log_filter
        self._stats = stats
        # Created at first dispatch, inside the running loop.
        self._sem: "asyncio.Semaphore | None" = None
        self._pool = ThreadPoolExecutor(max_workers=FETCH_WORKERS,
                                        thread_name_prefix="klogs-fetch")
        # (payload, offsets, n_lines, future, enqueue_time) per caller.
        self._pending: list[tuple] = []
        self._pending_lines = 0
        self._kick_handle: asyncio.TimerHandle | None = None
        self._closed = False
        # Strong references: the loop holds tasks weakly.
        self._tasks: set[asyncio.Task] = set()
        self.batches_dispatched = 0

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
        self._pending.append((payload, offsets, n, fut, time.perf_counter()))
        self._pending_lines += n
        if self._pending_lines >= COALESCE_LINES:
            self._kick(loop)
        elif self._kick_handle is None:
            self._kick_handle = loop.call_later(
                COALESCE_DELAY_S, self._kick, loop)
        return await fut

    def _kick(self, loop) -> None:
        if self._kick_handle is not None:
            self._kick_handle.cancel()
            self._kick_handle = None
        if not self._pending:
            return
        group, self._pending = self._pending, []
        self._pending_lines = 0
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
        try:
            if self._sem is None:
                self._sem = asyncio.Semaphore(MAX_IN_FLIGHT)
            async with self._sem:
                t_dispatch = time.perf_counter()
                if self._stats is not None:
                    self._stats.mark_batch_started(t_dispatch)
                    for e in group:
                        self._stats.record_queue_wait(t_dispatch - e[4])
                handle = self._filter.dispatch_framed(payload, offsets)
                self.batches_dispatched += 1
                verdicts = await loop.run_in_executor(
                    self._pool, self._filter.fetch_framed, handle)
                if self._stats is not None:
                    self._stats.record_device_batch(
                        time.perf_counter() - t_dispatch)
        except Exception as e:
            for _, _, _, fut, _ in group:
                if not fut.done():
                    fut.set_exception(e)
            return
        off = 0
        for _, _, n, fut, _ in group:
            if not fut.done():
                fut.set_result(verdicts[off:off + n])
            off += n

    async def aclose(self) -> None:
        """Dispatch any coalescing lines, drain in-flight batches, then
        release the pool and the engine."""
        self._closed = True
        if self._pending:
            self._kick(asyncio.get_running_loop())
        elif self._kick_handle is not None:
            self._kick_handle.cancel()
            self._kick_handle = None
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        await asyncio.to_thread(self._pool.shutdown)
        self._filter.close()
