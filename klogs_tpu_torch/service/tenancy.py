"""The multi-set registry of filterd and its weighted-fair admission.

Counterpart of ``klogs_tpu/service/tenancy.py``. One filterd, many
pattern sets: a collector registers its set once (content-addressed by
``pattern_fingerprint``, so two tenants with the same set share one
engine and one coalescer, and their frames merge into the same device
batches), then tags every match RPC with the set id it got back. What
a batch meets, in order:

- **Quota shed** (``KLOGS_TENANT_QUOTA_LINES``): a batch that would
  take its set's pending lines (admitted and waiting) past the quota
  is shed: the RPC fails RESOURCE_EXHAUSTED, the client raises
  ``Unavailable`` into ``--on-filter-error``, and
  ``klogs_tenant_shed_total{set}`` counts it.
- **Weighted-fair admission**: start-time fair queuing over
  ``KLOGS_TENANT_SLOTS`` admissions at once. Each lane's virtual time
  moves by ``lines / weight`` a batch and a free slot goes to the
  lowest stamp, so a flood queues behind its own tag while a quiet
  lane's next batch goes ahead of it.
- **One device budget**: every set's ``AsyncFilterService`` runs over
  one fetch pool and one in-flight semaphore, since the process owns
  one card.

A cold set is evicted (idle past ``KLOGS_TENANT_IDLE_S``, or the least
recently used past ``KLOGS_TENANT_MAX_SETS``): its service drains and
its engine is closed, which drops the engine's device tables. Under
``--backend cpu`` its DFA tables stay in the on-disk LRU of
filters/compiler/dfa.py ``build_dfa_cached``, so registering the set
again is a table load, not a determinization (a ``hit`` in
``klogs_prefilter_table_cache_events_total`` for an indexed set). A
match RPC naming an evicted set fails FAILED_PRECONDITION and the client
registers again.
"""

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from heapq import heappop, heappush
from typing import Any, Awaitable, Callable, Sequence

from klogs_tpu_torch.filters.async_service import (
    DEFAULT_FETCH_WORKERS,
    DEFAULT_MAX_IN_FLIGHT,
    AsyncFilterService,
)
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience import Unavailable
from klogs_tpu_torch.service.shard import pattern_fingerprint
from klogs_tpu_torch.utils.env import warn_nonneg_float as _env_float
from klogs_tpu_torch.utils.env import warn_positive_int as _env_int

# (patterns, exclude, ignore_case) -> LogFilter: the server passes its
# engine builder, tests a cheap one.
FilterFactory = Callable[[list[str], list[str], bool], Any]

DEFAULT_MAX_SETS = 32
DEFAULT_QUOTA_LINES = 65536
DEFAULT_IDLE_EVICT_S = 900.0
DEFAULT_SLOTS = 32


class _BuildCancelled(Exception):
    """Internal single-flight marker: the BUILDER's task was cancelled
    mid-compile (its client hung up). Distinct from CancelledError so
    a rider awaiting the shared build can tell 'the builder died —
    rebuild' from 'I was cancelled myself — propagate'; the two are
    indistinguishable when both surface as CancelledError."""


class OverQuota(Unavailable):
    """A lane's pending lines would exceed its quota: the batch is shed.
    Subclasses Unavailable so the collector's --on-filter-error degrade
    routing (the *existing* shed path) catches it — a shed batch is a
    counted degrade event, never a silent drop."""


class SetNotRegistered(KeyError):
    """Match RPC named a fingerprint the registry does not hold (never
    registered, or evicted while cold). The server maps this to
    FAILED_PRECONDITION; clients re-register and retry once."""

    def __init__(self, set_id: str) -> None:
        super().__init__(set_id)
        self.set_id = set_id

    def __str__(self) -> str:
        return (f"set {self.set_id} not registered (register first; a "
                "cold set may have been evicted)")


class _Lane:
    """Per-set admission state: the fair-queue tag plus quota
    accounting. One lane per registry entry; the default (startup) set
    gets one too, so legacy un-tagged traffic competes fairly instead
    of bypassing admission."""

    __slots__ = ("set_id", "weight", "quota_lines", "pending_lines",
                 "tag", "m_shed", "m_pending", "m_lines")

    def __init__(self, set_id: str, weight: float, quota_lines: int,
                 registry: Any = None) -> None:
        self.set_id = set_id
        self.weight = max(weight, 1e-6)
        self.quota_lines = quota_lines
        # Lines admitted or waiting for admission (quota accounting).
        self.pending_lines = 0
        # Start-time-fair-queuing virtual time (see FairGate).
        self.tag = 0.0
        self.m_shed: Any = None
        self.m_pending: Any = None
        self.m_lines: Any = None
        if registry is not None:
            # Per-set series are bounded by KLOGS_TENANT_MAX_SETS (a
            # deployment knob), satisfying the label-cardinality rule.
            self.m_shed = registry.family(
                "klogs_tenant_shed_total").labels(set=set_id)
            self.m_pending = registry.family(
                "klogs_tenant_pending_lines").labels(set=set_id)
            self.m_lines = registry.family(
                "klogs_tenant_lines_total").labels(set=set_id)

    def note_pending(self, delta: int) -> None:
        self.pending_lines += delta
        if self.m_pending is not None:
            self.m_pending.set(self.pending_lines)


class _Slot:
    """One granted admission, as an async context manager so the grant
    is always released (span-discipline-style) even when the dispatch
    below fails."""

    __slots__ = ("_gate", "_lane", "_cost")

    def __init__(self, gate: "FairGate", lane: _Lane, cost: int) -> None:
        self._gate = gate
        self._lane = lane
        self._cost = cost

    async def __aenter__(self) -> "_Slot":
        await self._gate.acquire(self._lane, self._cost)
        return self

    async def __aexit__(self, *exc: object) -> None:
        self._gate.release()


class FairGate:
    """Start-time fair queuing over a fixed number of admission slots.

    Each lane carries a virtual-time ``tag``; a request stamps
    ``start = max(global_floor, lane.tag)`` and advances the lane's tag
    by ``cost / weight``. Free slots are granted to the waiter with the
    lowest start stamp, so a flooding lane's requests queue behind its
    own inflated tag while a quiet lane's next request — whose tag
    lagged at the floor — is admitted at the next release. Everything
    runs on the one event loop; no locks."""

    def __init__(self, slots: int) -> None:
        self._free = slots
        # (start_tag, seq, future) — seq breaks ties FIFO.
        self._waiters: list[tuple[float, int, asyncio.Future]] = []
        self._seq = 0
        self._floor = 0.0

    @property
    def waiting(self) -> int:
        return len(self._waiters)

    def slot(self, lane: _Lane, cost: int) -> _Slot:
        return _Slot(self, lane, cost)

    async def acquire(self, lane: _Lane, cost: int) -> None:
        start = max(self._floor, lane.tag)
        lane.tag = start + float(max(cost, 1)) / lane.weight
        if self._free > 0 and not self._waiters:
            self._free -= 1
            self._floor = start
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._seq += 1
        heappush(self._waiters, (start, self._seq, fut))
        try:
            await fut
        except asyncio.CancelledError:
            # Granted-then-cancelled: the slot was already consumed on
            # our behalf — give it back or it leaks forever.
            if fut.done() and not fut.cancelled():
                self.release()
            raise

    def release(self) -> None:
        self._free += 1
        while self._waiters and self._free > 0:
            start, _, fut = heappop(self._waiters)
            if fut.done():  # cancelled while waiting
                continue
            self._free -= 1
            self._floor = start
            fut.set_result(None)


class SetEntry:
    """One registered pattern set: its compiled engine behind a per-set
    coalescer, plus the admission lane and eviction bookkeeping."""

    __slots__ = ("fingerprint", "patterns", "exclude", "ignore_case",
                 "service", "lane", "last_used", "pinned")

    def __init__(self, fingerprint: str, patterns: list[str],
                 exclude: list[str], ignore_case: bool,
                 service: AsyncFilterService, lane: _Lane,
                 pinned: bool = False) -> None:
        self.fingerprint = fingerprint
        self.patterns = patterns
        self.exclude = exclude
        self.ignore_case = ignore_case
        self.service = service
        self.lane = lane
        self.last_used = time.monotonic()
        # Pinned = the server's startup set: never evicted, and its
        # service is owned (and closed) by the server, not the registry.
        self.pinned = pinned

    def touch(self) -> None:
        self.last_used = time.monotonic()


class PatternSetRegistry:
    """Content-addressed pattern-set registry + tenant admission.

    ``register`` is single-flight per fingerprint: concurrent Register
    RPCs for the same set await one engine build, which runs in a worker
    thread, never on the event loop (a GpuEngineFilter at a thousand
    patterns takes seconds). A build that raises fails the registration
    and nothing else. The maps change under ``_mut``: banner and Hello
    read them synchronously while handlers register and evict."""

    def __init__(self, filter_factory: FilterFactory, *,
                 stats: Any = None,
                 max_sets: "int | None" = None,
                 quota_lines: "int | None" = None,
                 idle_evict_s: "float | None" = None,
                 slots: "int | None" = None) -> None:
        self._filter_factory = filter_factory
        self._stats = stats
        self._registry = stats.registry if stats is not None else None
        self.max_sets = (max_sets if max_sets is not None
                         else _env_int("KLOGS_TENANT_MAX_SETS",
                                       DEFAULT_MAX_SETS))
        self.quota_lines = (quota_lines if quota_lines is not None
                            else _env_int("KLOGS_TENANT_QUOTA_LINES",
                                          DEFAULT_QUOTA_LINES))
        self.idle_evict_s = (idle_evict_s if idle_evict_s is not None
                             else _env_float("KLOGS_TENANT_IDLE_S",
                                             DEFAULT_IDLE_EVICT_S))
        self._gate = FairGate(slots if slots is not None
                              else _env_int("KLOGS_TENANT_SLOTS",
                                            DEFAULT_SLOTS))
        # ONE fetch pool + ONE in-flight budget across every set: the
        # process owns one device; per-set pools would let one tenant
        # monopolize threads the fair gate never saw.
        self._pool = ThreadPoolExecutor(
            max_workers=DEFAULT_FETCH_WORKERS,
            thread_name_prefix="klogs-tenant-fetch")
        # Lazy (first Register runs on the loop): a Py3.10 asyncio
        # primitive binds the loop alive at construction, and the
        # registry may be built before serve() starts the real one.
        self._sem: "asyncio.Semaphore | None" = None
        self._mut = threading.Lock()
        self._sets: dict[str, SetEntry] = {}
        self._building: dict[str, asyncio.Future] = {}
        self._builds = 0
        self._closed = False
        self._m_sets: Any = None
        self._m_reg: Any = None
        self._m_builds: Any = None
        self._m_evict: Any = None
        self._m_wait: Any = None
        if self._registry is not None:
            r = self._registry
            self._m_sets = r.family("klogs_tenant_sets")
            self._m_reg = r.family("klogs_tenant_registrations_total")
            self._m_builds = r.family("klogs_tenant_engine_builds_total")
            self._m_evict = r.family("klogs_tenant_evictions_total")
            self._m_wait = r.family(
                "klogs_tenant_admission_wait_seconds")

    # -- introspection -------------------------------------------------

    @property
    def executor(self) -> ThreadPoolExecutor:
        """The ONE fetch pool every set's service shares — the server
        builds its pinned default-set service over it too, so legacy
        un-tagged traffic cannot double the device budget."""
        return self._pool

    @property
    def in_flight(self) -> asyncio.Semaphore:
        """The shared in-flight dispatch budget (see ``executor``),
        created on first use from the running loop."""
        if self._sem is None:
            self._sem = asyncio.Semaphore(DEFAULT_MAX_IN_FLIGHT)
        return self._sem

    @property
    def count(self) -> int:
        return len(self._sets)

    @property
    def engine_builds(self) -> int:
        """Engines compiled by this registry (test hook mirroring
        klogs_tenant_engine_builds_total): content-addressed reuse
        means a second registration of the same fingerprint must NOT
        advance this."""
        return self._builds

    def get(self, set_id: str) -> "SetEntry | None":
        return self._sets.get(set_id)

    def entries(self) -> "list[SetEntry]":
        """Point-in-time snapshot of the live entries (lock-free read,
        like every other registry read)."""
        return list(self._sets.values())

    def fingerprints(self) -> list[str]:
        return sorted(self._sets)

    # -- registration / eviction --------------------------------------

    async def register(self, patterns: Sequence[str],
                       exclude: "Sequence[str] | None" = None,
                       ignore_case: bool = False,
                       weight: float = 1.0) -> "tuple[str, bool]":
        """Register (or re-register) a pattern set. Returns
        ``(fingerprint, shared)`` — shared=True when the engine already
        existed (content-addressed reuse, no compile)."""
        if self._closed:
            raise RuntimeError("registry is closed")
        pats = [str(p) for p in patterns]
        excl = [str(p) for p in exclude or []]
        fp = pattern_fingerprint(pats, excl, ignore_case)
        while True:
            entry = self._sets.get(fp)
            if entry is not None:
                entry.touch()
                # Highest registered weight wins: a tenant asking for
                # more share must not be silently capped by whoever
                # registered the set first.
                if weight > entry.lane.weight:
                    entry.lane.weight = weight
                if self._m_reg is not None:
                    self._m_reg.labels(outcome="shared").inc()
                return fp, True
            fut = self._building.get(fp)
            if fut is not None:
                # Single-flight: ride the in-progress build, then loop
                # to pick the entry up (or surface the build error).
                # A _BuildCancelled means the builder died mid-compile
                # — loop and become the new builder; a CancelledError
                # is OUR OWN cancellation and propagates.
                try:
                    await asyncio.shield(fut)
                except _BuildCancelled:
                    pass
                continue
            break
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        # Retrieve a failed build's exception even when no concurrent
        # registrant awaited it (suppresses the never-retrieved warn).
        fut.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None)
        with self._mut:
            self._building[fp] = fut
        try:
            # The build (regex compile, programs, gate tables, their
            # copies to the card) blocks: off the loop, or one tenant's
            # thousand-pattern registration stalls every other's RPCs.
            filt = await asyncio.to_thread(
                self._filter_factory, list(pats), list(excl), ignore_case)
            self._builds += 1
            service = AsyncFilterService(
                filt, stats=self._stats, executor=self._pool,
                in_flight=self.in_flight)
            lane = _Lane(fp, weight, self.quota_lines,
                         registry=self._registry)
            entry = SetEntry(fp, pats, excl, ignore_case, service, lane)
            with self._mut:
                self._sets[fp] = entry
            if self._m_builds is not None:
                self._m_builds.inc()
            if self._m_reg is not None:
                self._m_reg.labels(outcome="new").inc()
            if self._m_sets is not None:
                self._m_sets.set(len(self._sets))
            fut.set_result(fp)
        except BaseException as e:
            # Riders must see the builder's cancellation as the marker
            # type, never as a bare CancelledError they would mistake
            # for their own (see _BuildCancelled).
            fut.set_exception(
                _BuildCancelled() if isinstance(
                    e, asyncio.CancelledError) else e)
            raise
        finally:
            with self._mut:
                self._building.pop(fp, None)
        await self._evict_over_capacity()
        return fp, False

    def adopt(self, patterns: Sequence[str],
              exclude: "Sequence[str] | None",
              ignore_case: bool,
              service: AsyncFilterService) -> str:
        """Adopt the server's startup set (already compiled in
        FilterServer.__init__) as a pinned entry, so legacy un-tagged
        RPCs route through the same admission machinery while the
        single-set compile path stays byte-identical."""
        pats = [str(p) for p in patterns]
        excl = [str(p) for p in exclude or []]
        fp = pattern_fingerprint(pats, excl, ignore_case)
        lane = _Lane(fp, 1.0, self.quota_lines, registry=self._registry)
        entry = SetEntry(fp, pats, excl, ignore_case, service, lane,
                         pinned=True)
        with self._mut:
            self._sets[fp] = entry
        if self._m_sets is not None:
            self._m_sets.set(len(self._sets))
        return fp

    async def evict(self, fp: str, reason: str) -> bool:
        """Drain one set's service and close its engine, which drops
        its device tables; registering the set again builds a new
        engine, from the DFA table cache on disk under --backend cpu."""
        entry = self._sets.get(fp)
        if entry is None or entry.pinned:
            return False
        with self._mut:
            self._sets.pop(fp, None)
        if self._registry is not None and reason != "shutdown":
            # Drop the evicted set's per-set series: the `set` label's
            # cardinality is bounded by LIVE sets, not lifetime churn —
            # without this, a long-lived registry cycling fingerprints
            # grows dead series (and a stale pending gauge) forever.
            # BEFORE the drain below: a transparent re-registration of
            # the same fingerprint can complete while the old service
            # drains, and removing afterwards would orphan the revived
            # lane's freshly created children. Shutdown skips removal:
            # the registry dies with the process and final counters
            # should stay scrapeable at teardown.
            for fam in ("klogs_tenant_shed_total",
                        "klogs_tenant_pending_lines",
                        "klogs_tenant_lines_total"):
                self._registry.family(fam).remove(set=fp)
        # Drain in-flight groups, close the engine; the SHARED fetch
        # pool survives (AsyncFilterService only shuts a pool it owns).
        await entry.service.aclose()
        if self._m_evict is not None:
            self._m_evict.labels(reason=reason).inc()
        if self._m_sets is not None:
            self._m_sets.set(len(self._sets))
        trace.TRACER.event("tenant.evict", tenant=fp, reason=reason)
        return True

    async def _evict_over_capacity(self) -> None:
        # The cap counts REGISTERED tenant sets only: the pinned
        # startup set rides free, or a max_sets=1 server with a default
        # set would evict every tenant the instant it registered — a
        # permanent register/FAILED_PRECONDITION loop.
        while sum(1 for e in self._sets.values()
                  if not e.pinned) > self.max_sets:
            victims = sorted(
                (e for e in self._sets.values() if not e.pinned),
                # Idle lanes first, then least-recently-used (the
                # just-registered entry carries the newest last_used,
                # so it is never its own victim).
                key=lambda e: (e.lane.pending_lines > 0, e.last_used))
            if not victims:
                return
            await self.evict(victims[0].fingerprint, "capacity")

    async def run_idle_sweeper(self, stop: asyncio.Event,
                               interval_s: "float | None" = None) -> None:
        """Periodic cold-set reaper; run as a background task on the
        server. Stop-aware wait (the blessed poller idiom)."""
        if self.idle_evict_s <= 0:
            return
        period = interval_s if interval_s is not None else max(
            self.idle_evict_s / 4.0, 0.05)
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=period)
                return
            except asyncio.TimeoutError:
                pass
            now = time.monotonic()
            for fp, entry in list(self._sets.items()):
                if (not entry.pinned and entry.lane.pending_lines == 0
                        and now - entry.last_used >= self.idle_evict_s):
                    try:
                        await self.evict(fp, "idle")
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001
                        # One failing engine teardown must not kill the
                        # sweeper for the rest of the run (cold sets
                        # would then silently pile up to the cap).
                        from klogs_tpu_torch.ui import term

                        term.warning(
                            "tenant set %s idle eviction failed: %s",
                            fp, e)

    # -- admission + dispatch -----------------------------------------

    def _admit(self, set_id: str, n: int) -> SetEntry:
        entry = self._sets.get(set_id)
        if entry is None:
            raise SetNotRegistered(set_id)
        entry.touch()
        lane = entry.lane
        if n > 0 and lane.pending_lines + n > lane.quota_lines:
            if lane.m_shed is not None:
                lane.m_shed.inc()
            trace.TRACER.event("tenant.shed", tenant=set_id, lines=n,
                               pending=lane.pending_lines)
            raise OverQuota(
                f"set {set_id} over quota: {lane.pending_lines} lines "
                f"pending + {n} new > {lane.quota_lines} "
                "(KLOGS_TENANT_QUOTA_LINES)")
        return entry

    async def _dispatch(self, set_id: str, n: int,
                        run: "Callable[[SetEntry], Awaitable[Any]]"
                        ) -> Any:
        entry = self._admit(set_id, n)
        lane = entry.lane
        lane.note_pending(n)
        t0 = time.perf_counter()
        try:
            # The tenant attr lets a flight-recorder dump or a
            # --trace-json stream attribute a stall to its set.
            with trace.TRACER.span("tenant.admit", tenant=set_id,
                                   lines=n) as sp:
                async with self._gate.slot(lane, max(n, 1)):
                    wait = time.perf_counter() - t0
                    sp.set_attr("admission_wait_s", wait)
                    if self._m_wait is not None:
                        self._m_wait.observe(wait)
                    if lane.m_lines is not None:
                        lane.m_lines.inc(n)
                    try:
                        return await run(entry)
                    except RuntimeError as e:
                        # Exact sentinel only: a device/channel
                        # RuntimeError that merely mentions "closed"
                        # is a real failure, not an eviction, and must
                        # not be masked as re-register-and-retry.
                        if str(e) == "AsyncFilterService is closed":
                            # Admission raced an eviction: the entry was
                            # live at _admit but its service closed
                            # before dispatch. Same contract as a fully
                            # evicted set — the client re-registers.
                            raise SetNotRegistered(set_id) from e
                        raise
        finally:
            lane.note_pending(-n)

    async def match_framed(self, set_id: str, payload: bytes,
                           offsets: Any) -> Any:
        n = max(len(offsets) - 1, 0)
        return await self._dispatch(
            set_id, n,
            lambda e: e.service.match_framed(payload, offsets))

    async def match(self, set_id: str, lines: "list[bytes]"
                    ) -> "list[bool]":
        return await self._dispatch(
            set_id, len(lines), lambda e: e.service.match(lines))

    # -- teardown -----------------------------------------------------

    async def aclose(self) -> None:
        self._closed = True
        for fp, entry in list(self._sets.items()):
            if entry.pinned:
                # The server owns (and closes) its startup service.
                with self._mut:
                    self._sets.pop(fp, None)
                continue
            await self.evict(fp, "shutdown")
        await asyncio.to_thread(self._pool.shutdown)
