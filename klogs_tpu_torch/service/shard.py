"""The sharded filterd tier: one collector, N filter servers.

Counterpart of ``klogs_tpu/service/shard.py``. ``ShardedFilterClient``
wraps one ``RemoteFilterClient`` per endpoint behind the one-client API
the sink speaks (``hello``, ``verify_patterns``, ``match``,
``match_framed``, ``aclose``), so a fleet stands wherever one
``--remote`` server did, and a dead or draining server is a routing
event rather than an outage. The endpoints may be the port's filterds
or the JAX package's: the wire, the set ids and the ring are the same.

What a batch meets, in order:

- **Live membership** (``--resolver``, service/resolver.py): polled on
  ``KLOGS_RESOLVER_INTERVAL_S``; each snapshot is diffed into the fleet
  by ``apply_membership`` under a ring generation, and a dispatch that
  sees the generation move re-routes. Joiners are unverified until
  their Hello passes the pattern-set check; an empty or failed
  resolution keeps the current fleet.
- **Routing** (``--shard-mode``): ``round-robin`` rotates per batch;
  ``hash`` pins the pattern-set fingerprint to its owner on a
  consistent-hash ring of ``_RING_VNODES`` virtual nodes an endpoint,
  so identical collectors meet on one server and a lost endpoint moves
  only its own keys.
- **Capacity weights** (round-robin only): Hello's ``headroom`` is a
  weight (floor 0.05), applied by smooth weighted round-robin and
  decayed toward uniform over ``KLOGS_WEIGHT_DECAY_S`` (0: off).
- **Breakers**: each inner client has its own (``rpc@host:port``); an
  open one demotes its endpoint to last resort.
- **Readiness drain**: an endpoint whose Hello names a metrics port has
  its ``/readyz`` polled; a 503 or silence routes around it until it
  answers 200 again.
- **Hedges**: an attempt silent for ``hedge_s`` is raced against the
  next sibling; the first success wins, the losers are cancelled and
  awaited, and the sink records one result.
- **Failover**: an attempt that ends ``Unavailable`` passes the batch
  on; only when every endpoint failed does the dispatch raise
  ``Unavailable``, the type ``--on-filter-error`` routes.
"""

import asyncio
import bisect
import hashlib
import time
from typing import TYPE_CHECKING, Any, Awaitable, Callable, Iterable, Sequence

if TYPE_CHECKING:
    from klogs_tpu_torch.service.resolver import Resolver

from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience import (
    BREAKER_OPEN,
    BreakerOpen,
    CircuitBreaker,
    Unavailable,
)
from klogs_tpu_torch.service.client import (
    PatternMismatch,
    RemoteFilterClient,
    ServiceConfigError,
    check_server_config,
)
from klogs_tpu_torch.ui import term

SHARD_MODES = ("round-robin", "hash")

# A batch takes milliseconds on a healthy filterd; a second of silence
# means it compiles, drains or is gone (KLOGS_HEDGE_S).
DEFAULT_HEDGE_S = 1.0
DEFAULT_PROBE_INTERVAL_S = 1.0
DEFAULT_PROBE_TIMEOUT_S = 1.0
# The prober's refresh of each endpoint's Hello capacity keys for the
# klogs_fleet_endpoint_* series (KLOGS_FLEET_REFRESH_S).
DEFAULT_CAPACITY_REFRESH_S = 5.0

# Virtual nodes an endpoint on the hash ring: a lost endpoint's keys
# spread about evenly over the survivors.
_RING_VNODES = 64

# How long an advertised headroom is trusted in full before its weight
# decays linearly to uniform (KLOGS_WEIGHT_DECAY_S; 0: no weighting).
DEFAULT_WEIGHT_DECAY_S = 30.0
# A saturated endpoint keeps this weight: it stays a failover candidate
# and sees the odd batch, so its recovery shows.
_WEIGHT_FLOOR = 0.05


def parse_endpoints(spec: str) -> list[str]:
    """A comma-separated ``--remote`` list, each entry checked now: a
    malformed target fails naming itself at startup, not as a gRPC
    error mid-run."""
    targets: list[str] = []
    seen: set[str] = set()
    for raw in spec.split(","):
        target = raw.strip()
        if not target:
            raise ServiceConfigError(
                f"--remote list {spec!r} contains an empty entry")
        _validate_target(target)
        if target in seen:
            raise ServiceConfigError(
                f"--remote lists endpoint {target!r} more than once")
        seen.add(target)
        targets.append(target)
    return targets


def _validate_target(target: str) -> None:
    """HOST:PORT or unix:/path.sock, or ServiceConfigError naming it."""
    if target.startswith("unix:"):
        if len(target) == len("unix:"):
            raise ServiceConfigError(
                f"malformed --remote endpoint {target!r}: empty unix "
                "socket path")
        return
    host, sep, port = target.rpartition(":")
    if not sep or not host:
        raise ServiceConfigError(
            f"malformed --remote endpoint {target!r} (want HOST:PORT "
            "or unix:/path.sock)")
    if not port.isdigit() or not 0 < int(port) < 65536:
        raise ServiceConfigError(
            f"malformed --remote endpoint {target!r}: bad port {port!r}")


def pattern_fingerprint(patterns: Sequence[str],
                        exclude: "Sequence[str] | None" = None,
                        ignore_case: bool = False) -> str:
    """The content id of a pattern set: a multi-set filterd's set id on
    the wire and the hash ring's key, equal to the JAX package's byte
    for byte. Order matters, as in the Hello check."""
    h = hashlib.sha256()
    for p in patterns:
        h.update(b"m\x00" + p.encode() + b"\x00")
    for p in exclude or ():
        h.update(b"x\x00" + p.encode() + b"\x00")
    h.update(b"i" if ignore_case else b"c")
    return h.hexdigest()[:16]


class _Endpoint:
    """One fleet member: the wrapped client plus the router's view of
    its health (prober-observed readiness; the breaker lives on the
    client)."""

    __slots__ = ("target", "client", "ready", "readyz", "verified",
                 "quarantined", "cap_offered", "cap_admitted", "cap_next",
                 "weight", "cap_at", "wrr")

    def __init__(self, target: str, client: Any) -> None:
        self.target = target
        self.client = client
        # Unknown = routable: a fleet with no metrics ports configured
        # must still route everywhere (breakers alone protect it).
        self.ready = True
        self.readyz: "tuple[str, int] | None" = None
        # Last capacity totals this endpoint's Hello advertised (the
        # collector-side counter re-export advances by deltas) and
        # when the prober should refresh them next.
        self.cap_offered: "int | None" = None
        self.cap_admitted: "int | None" = None
        self.cap_next = 0.0
        # Capacity-weighted routing state: the raw headroom-derived
        # weight, when it was advertised (None = never — weight stays
        # uniform), and the smooth-WRR accumulator.
        self.weight = 1.0
        self.cap_at: "float | None" = None
        self.wrr = 0.0
        # verified False = the endpoint was unreachable during the
        # startup handshake: it must not receive traffic until a later
        # Hello proves its pattern set matches (the prober re-tries).
        # quarantined = it came back with a DRIFTED set: permanently
        # excluded — mis-filtered output is worse than less capacity.
        self.verified = True
        self.quarantined = False

    @property
    def breaker(self) -> CircuitBreaker:
        return self.client.breaker


class ShardedFilterClient:
    """N ``RemoteFilterClient``s behind the one-client API.

    ``client_factory`` (tests) builds the per-endpoint client; the
    default builds a ``RemoteFilterClient`` with ``client_kwargs``
    (TLS/auth/timeout config shared across the fleet) and a
    per-endpoint breaker named ``rpc@<target>``.
    """

    def __init__(self, targets: Iterable[str], *,
                 shard_mode: str = "round-robin",
                 fingerprint: str = "",
                 hedge_s: "float | None" = DEFAULT_HEDGE_S,
                 probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
                 probe_timeout_s: float = DEFAULT_PROBE_TIMEOUT_S,
                 registry: Any = None,
                 client_factory: "Callable[[str], Any] | None" = None,
                 resolver: "Resolver | None" = None,
                 **client_kwargs: Any) -> None:
        if shard_mode not in SHARD_MODES:
            raise ServiceConfigError(
                f"unknown --shard-mode {shard_mode!r} "
                f"(want {' | '.join(SHARD_MODES)})")
        target_list = list(targets)
        if not target_list and resolver is None:
            # With a resolver, an empty seed list is legal: the first
            # membership fill happens in verify_patterns, inside the
            # running loop, from the resolver's own snapshot.
            raise ServiceConfigError("--remote endpoint list is empty")
        seen: set[str] = set()
        for t in target_list:
            # Same wording as parse_endpoints (which guards the CLI
            # path); re-checked here for direct library construction.
            if t in seen:
                raise ServiceConfigError(
                    f"--remote lists endpoint {t!r} more than once")
            seen.add(t)
        if client_factory is None:
            def client_factory(target: str) -> Any:
                return RemoteFilterClient(target, registry=registry,
                                          **client_kwargs)
        self._client_factory = client_factory
        self._mode = shard_mode
        self._fingerprint = fingerprint
        # The collector's pattern-set invocation, remembered by
        # verify_patterns so an endpoint that was down at startup can
        # be verified when it comes back (see _late_verify).
        self._expected: "tuple[list[str], bool, list[str]] | None" = None
        self._hedge_s = hedge_s
        self._probe_interval_s = probe_interval_s
        self._probe_timeout_s = probe_timeout_s
        self._registry = registry
        self._endpoints = [_Endpoint(t, client_factory(t))
                           for t in target_list]
        self._rr = 0  # round-robin cursor (per-batch rotation)
        # Hash mode: endpoints and fingerprint are fixed for the life
        # of the client, so the ring walk is a constant — computed once
        # here, not per batch (demotion/exclusion happens later, in
        # _route_order, against live health state).
        self._hash_order: "list[int]" = (
            self._ring_walk() if shard_mode == "hash" else [])
        self._probe_task: "asyncio.Task | None" = None
        # Created lazily inside the running loop (_ensure_prober): an
        # Event constructed here would bind/require the thread's event
        # loop on older Pythons, and this constructor legitimately runs
        # before any loop exists (make_pipeline at CLI startup, tests).
        self._probe_stop: "asyncio.Event | None" = None
        self._m_hedges: Any = None
        self._m_reroutes: Any = None
        self._m_batches: Any = None
        self._m_ready: Any = None
        self._m_cap_head: Any = None
        self._m_cap_off: Any = None
        self._m_cap_adm: Any = None
        self._m_weight: Any = None
        self._m_member_events: Any = None
        self._m_member_size: Any = None
        from klogs_tpu_torch.utils.env import nonneg_float, positive_float

        self._cap_refresh_s = positive_float(
            "KLOGS_FLEET_REFRESH_S", DEFAULT_CAPACITY_REFRESH_S,
            exc=ServiceConfigError)
        # Validated at construction (startup), not first use inside the
        # prober task — a malformed knob must fail naming itself, not
        # silently kill background routing mid-run.
        try:
            self._weight_decay_s = nonneg_float(
                "KLOGS_WEIGHT_DECAY_S", DEFAULT_WEIGHT_DECAY_S)
        except ValueError as e:
            raise ServiceConfigError(str(e)) from None
        # Live membership (service/resolver.py): polled by the prober
        # on its own cadence; 0.0 forces a poll on the first cycle.
        self._resolver = resolver
        self._resolver_next = 0.0
        self._resolver_interval_s = 0.0
        if resolver is not None:
            from klogs_tpu_torch.service.resolver import (
                DEFAULT_RESOLVE_INTERVAL_S,
            )

            self._resolver_interval_s = positive_float(
                "KLOGS_RESOLVER_INTERVAL_S", DEFAULT_RESOLVE_INTERVAL_S,
                exc=ServiceConfigError)
        # Bumped on every membership change; _dispatch snapshots it and
        # re-routes when it moves mid-batch (the ring-generation guard).
        self._ring_gen = 0
        # Retired endpoints' channel-close tasks: strong refs so they
        # cannot be GC'd mid-close, settled in aclose.
        self._member_tasks: "set[asyncio.Task]" = set()
        if registry is not None:
            self._m_hedges = registry.family("klogs_shard_hedges_total")
            self._m_reroutes = registry.family("klogs_shard_reroutes_total")
            self._m_batches = registry.family("klogs_shard_batches_total")
            self._m_ready = registry.family("klogs_shard_endpoint_ready")
            self._m_cap_head = registry.family(
                "klogs_fleet_endpoint_headroom")
            self._m_cap_off = registry.family(
                "klogs_fleet_endpoint_offered_lines_total")
            self._m_cap_adm = registry.family(
                "klogs_fleet_endpoint_admitted_lines_total")
            self._m_weight = registry.family("klogs_shard_endpoint_weight")
            self._m_member_events = registry.family(
                "klogs_fleet_membership_events_total")
            self._m_member_size = registry.family(
                "klogs_fleet_membership_size")
            self._m_member_size.set(len(self._endpoints))
            for ep in self._endpoints:
                self._m_ready.labels(endpoint=ep.target).set(1)

    # -- routing ------------------------------------------------------

    def _ring_walk(self) -> "list[int]":
        """Endpoint indices in consistent-hash order for this client's
        fingerprint: the ring (vnodes per endpoint) walked clockwise
        from the fingerprint's position, first occurrence of each
        endpoint kept."""
        ring: "list[tuple[int, int]]" = []
        for i, ep in enumerate(self._endpoints):
            for v in range(_RING_VNODES):
                digest = hashlib.sha256(
                    f"{ep.target}#{v}".encode()).digest()
                ring.append((int.from_bytes(digest[:8], "big"), i))
        ring.sort()
        key = int.from_bytes(hashlib.sha256(
            self._fingerprint.encode()).digest()[:8], "big")
        start = bisect.bisect_left(ring, (key, -1))
        order: "list[int]" = []
        seen: set[int] = set()
        for j in range(len(ring)):
            _, i = ring[(start + j) % len(ring)]
            if i not in seen:
                seen.add(i)
                order.append(i)
                if len(order) == len(self._endpoints):
                    break
        return order

    def _natural_order(self) -> "list[_Endpoint]":
        """Health-blind candidate order: the pure routing policy."""
        if not self._endpoints:
            # Legal mid-run with a resolver: the fleet can shrink to
            # zero between polls (every dispatch then raises
            # Unavailable until membership recovers).
            return []
        if self._mode == "hash":
            return [self._endpoints[i] for i in self._hash_order]
        i = self._rr % len(self._endpoints)
        self._rr += 1
        return self._endpoints[i:] + self._endpoints[:i]

    def _effective_weight(self, ep: _Endpoint, now: float) -> float:
        """Headroom-learned weight decayed toward uniform 1.0 as the
        last capacity sample ages: a silent prober (endpoint stopped
        answering Hello, so ``cap_at`` froze) loses its learned bias
        within ``KLOGS_WEIGHT_DECAY_S`` instead of starving — or
        forever favoring — anyone."""
        if self._weight_decay_s <= 0 or ep.cap_at is None:
            return 1.0
        fresh = max(0.0, 1.0 - (now - ep.cap_at) / self._weight_decay_s)
        return 1.0 + fresh * (ep.weight - 1.0)

    def _weighted_order(self,
                        healthy: "list[_Endpoint]"
                        ) -> "list[_Endpoint] | None":
        """Smooth weighted round-robin over the healthy set (nginx
        algorithm: deterministic, no starvation — every endpoint is
        visited, just proportionally less often). Returns None when
        weighting is disabled or the weights are effectively uniform,
        so the caller keeps today's rotation byte-identically."""
        if self._weight_decay_s <= 0:
            return None
        now = time.monotonic()
        weights = [self._effective_weight(ep, now) for ep in healthy]
        if max(weights) - min(weights) < 1e-6:
            return None
        total = 0.0
        for ep, w in zip(healthy, weights):
            ep.wrr += w
            total += w
        order = sorted(healthy, key=lambda ep: -ep.wrr)
        order[0].wrr -= total
        return order

    def _route_order(self) -> "list[_Endpoint]":
        """Candidate order for one batch: available endpoints first (in
        policy order), the unready/broken ones demoted to last resort —
        tried only after every healthy sibling failed, which is what
        makes --on-filter-error degrade fire only when the WHOLE fleet
        is down. Skipping the natural owner is counted per endpoint and
        reason. Unverified/quarantined endpoints are EXCLUDED, not
        demoted: a server whose pattern set was never (or wrongly)
        verified would silently mis-filter — worse than losing its
        capacity."""
        natural = [ep for ep in self._natural_order()
                   if ep.verified and not ep.quarantined]
        if not natural:
            return []
        # One health snapshot per routing decision (breaker.state can
        # flip open->half-open on the clock mid-iteration) — the
        # reroute reason derives from the SAME snapshot, or the label
        # could misattribute a breaker trip to readiness drain.
        state = {ep.target: ep.breaker.state for ep in natural}
        avail = {ep.target: (ep.ready
                             and state[ep.target] != BREAKER_OPEN)
                 for ep in natural}
        healthy = [ep for ep in natural if avail[ep.target]]
        if not healthy:
            return natural
        for ep in natural:
            if ep is healthy[0]:
                break
            reason = ("breaker" if state[ep.target] == BREAKER_OPEN
                      else "unready")
            if self._m_reroutes is not None:
                self._m_reroutes.labels(endpoint=ep.target,
                                        reason=reason).inc()
            # The batch trace records WHICH owner was skipped and why —
            # the per-batch story the aggregate counter cannot tell.
            trace.TRACER.event("shard.reroute", endpoint=ep.target,
                               reason=reason)
        # Capacity weighting reorders WITHIN the healthy set only, and
        # only in round-robin mode (hash mode pins ownership — skipping
        # the ring owner for capacity would churn key placement). It
        # runs AFTER the reroute accounting above: weighting is policy,
        # not a health event.
        if self._mode == "round-robin" and len(healthy) > 1:
            weighted = self._weighted_order(healthy)
            if weighted is not None:
                healthy = weighted
        return healthy + [ep for ep in natural if not avail[ep.target]]

    def _note_endpoint_down(self, ep: _Endpoint) -> None:
        """A dispatch just failed terminally at ``ep``. If its breaker
        has opened, the server is down — and downtime is the redeploy
        window: whatever comes back on that address may serve a
        DIFFERENT pattern set. Demote it to unverified so the prober
        must re-run the handshake before it gets another batch (only
        meaningful when verify_patterns armed the expected config)."""
        if (self._expected is not None and ep.verified
                and ep.breaker.state == BREAKER_OPEN):
            ep.verified = False
            if self._m_ready is not None:
                self._m_ready.labels(endpoint=ep.target).set(0)
            self._ensure_prober()

    # -- live membership ----------------------------------------------

    def _member_event(self, action: str) -> None:
        if self._m_member_events is not None:
            self._m_member_events.labels(action=action).inc()

    async def apply_membership(self, targets: "Iterable[str]"
                               ) -> "tuple[list[str], list[str]]":
        """Diff a resolver snapshot against live membership and apply
        it: joiners enter the fleet UNVERIFIED (the prober's
        verify-before-rejoin handshake gates their first batch, unless
        no expected config is armed yet), leavers have their channels
        retired in the background and their per-endpoint series
        dropped. Any change bumps the ring generation so an in-flight
        dispatch re-routes. Returns (added, removed) target lists."""
        valid: "list[str]" = []
        seen: "set[str]" = set()
        for raw in targets:
            t = raw.strip()
            if not t or t in seen:
                continue
            try:
                _validate_target(t)
            except ServiceConfigError as e:
                # One bad record must not poison the snapshot: keep
                # the good entries, skip (and count) the bad one.
                self._member_event("error")
                term.warning("resolver returned a malformed endpoint "
                             "%r (%s); skipping it", t, e)
                continue
            seen.add(t)
            valid.append(t)
        if not valid and self._endpoints:
            # Refuse to drain the whole fleet on a (possibly bogus)
            # empty snapshot — a half-deployed Endpoints object or a
            # truncated file must not stop a flowing pipeline. Scale-
            # to-zero on purpose is a restart-sized decision anyway.
            self._member_event("error")
            term.warning(
                "resolver returned an EMPTY endpoint set; keeping the "
                "current fleet of %d", len(self._endpoints))
            return [], []
        current = {ep.target for ep in self._endpoints}
        added = [t for t in valid if t not in current]
        removed = [t for t in current if t not in seen]
        if not added and not removed:
            return [], []
        keep = [ep for ep in self._endpoints if ep.target in seen]
        leavers = [ep for ep in self._endpoints if ep.target not in seen]
        for t in added:
            ep = _Endpoint(t, self._client_factory(t))
            # Pre-handshake joins (resolver seeding before
            # verify_patterns) are verified by the imminent handshake
            # itself; post-handshake joiners wait for the prober.
            ep.verified = self._expected is None
            keep.append(ep)
            self._member_event("add")
            if self._m_ready is not None:
                self._m_ready.labels(endpoint=ep.target).set(
                    1 if ep.verified else 0)
            term.info("filterd %s joined the fleet%s", t,
                      "" if ep.verified
                      else " (unverified until its pattern set checks)")
        self._endpoints = keep
        for ep in leavers:
            self._member_event("remove")
            await self._retire(ep)
            term.info("filterd %s left the fleet", ep.target)
        self._ring_gen += 1
        if self._mode == "hash":
            self._hash_order = self._ring_walk()
        if self._m_member_size is not None:
            self._m_member_size.set(len(self._endpoints))
        self._ensure_prober()
        return added, removed

    async def _retire(self, ep: _Endpoint) -> None:
        """Close a leaver's channel off the hot path and drop its
        per-endpoint series (a scrape must not keep exporting a gauge
        for an endpoint that no longer exists)."""
        for fam in (self._m_ready, self._m_cap_head, self._m_cap_off,
                    self._m_cap_adm, self._m_weight):
            if fam is not None:
                fam.remove(endpoint=ep.target)

        async def _close(client: Any = ep.client) -> None:
            try:
                await client.aclose()
            except Exception:  # noqa: BLE001
                pass  # retirement teardown; the channel is gone either way

        task = asyncio.get_running_loop().create_task(_close())
        self._member_tasks.add(task)
        task.add_done_callback(self._member_tasks.discard)

    async def _resolve_step(self) -> None:
        """One membership poll: ask the resolver for the current fleet
        and apply the diff. Every failure mode keeps the current
        membership — discovery is advisory, never load-bearing."""
        self._resolver_next = (time.monotonic()
                               + self._resolver_interval_s)
        assert self._resolver is not None
        try:
            targets = await self._resolver.resolve()
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            # ResolverError, InjectedFault, or a resolver bug: all
            # transient from membership's point of view.
            self._member_event("error")
            term.warning("endpoint resolver %s failed (%s); keeping the "
                         "current fleet of %d",
                         self._resolver.describe(), e,
                         len(self._endpoints))
            return
        await self.apply_membership(targets)

    # -- dispatch -----------------------------------------------------

    async def _dispatch(self,
                        op: "Callable[[Any], Awaitable[Any]]",
                        what: str) -> Any:
        """Run one batch against the fleet: primary attempt, a hedge
        against the next sibling every ``hedge_s`` of silence, failover
        past terminal failures, first success wins. Losers are
        cancelled and awaited before returning — no orphan tasks, no
        double-counted result.

        The whole decision runs under one ``shard.dispatch`` span;
        routing demotions, hedges, per-endpoint failures, and the
        winner land on it as events, and each attempt task inherits the
        span as parent (its ``rpc.client`` span nests under it; a
        cancelled loser's closes status=cancelled)."""
        with trace.TRACER.span("shard.dispatch", what=what,
                               mode=self._mode) as sp:
            queue = list(self._route_order())
            gen = self._ring_gen
            tasks: "dict[asyncio.Task, _Endpoint]" = {}
            errors: "list[str]" = []
            pending: "set[asyncio.Task]" = set()
            try:
                while queue or pending:
                    if self._ring_gen != gen:
                        # Membership changed mid-batch: the queued
                        # candidates may include retired endpoints (or
                        # miss fresh ones). Re-route from the current
                        # ring, keeping attempts already in flight.
                        gen = self._ring_gen
                        attempted = {tasks[t].target for t in tasks}
                        queue = [ep for ep in self._route_order()
                                 if ep.target not in attempted]
                        if not queue and not pending:
                            break  # refresh drained the candidates
                    if not pending:
                        ep = queue.pop(0)
                        sp.add_event("shard.route", endpoint=ep.target)
                        t = asyncio.ensure_future(op(ep.client))
                        tasks[t] = ep
                        pending = {t}
                    timeout = (self._hedge_s
                               if queue and self._hedge_s is not None
                               else None)
                    done, pending = await asyncio.wait(
                        pending, timeout=timeout,
                        return_when=asyncio.FIRST_COMPLETED)
                    if not done:
                        # Hedge deadline passed with the attempt(s)
                        # still in flight: race one more sibling.
                        ep = queue.pop(0)
                        if self._m_hedges is not None:
                            self._m_hedges.labels(endpoint=ep.target).inc()
                        sp.add_event("shard.hedge", endpoint=ep.target)
                        t = asyncio.ensure_future(op(ep.client))
                        tasks[t] = ep
                        pending.add(t)
                        continue
                    winner: "asyncio.Task | None" = None
                    fatal: "BaseException | None" = None
                    for t in done:
                        exc = t.exception() if not t.cancelled() else None
                        if t.cancelled():
                            continue
                        if exc is None:
                            winner = winner or t
                        elif (isinstance(exc, Unavailable)
                              or tasks[t] not in self._endpoints):
                            # An endpoint retired mid-attempt fails however
                            # its closed channel says so (grpc's
                            # UsageError, a cancelled call): no fault of
                            # the batch, which fails over as from an
                            # Unavailable one. (The JAX tier raises it.)
                            ep = tasks[t]
                            member = ep in self._endpoints
                            errors.append(f"{ep.target}: {exc}")
                            reason = ("breaker"
                                      if isinstance(exc, BreakerOpen)
                                      else "error")
                            if self._m_reroutes is not None and member:
                                self._m_reroutes.labels(
                                    endpoint=ep.target, reason=reason).inc()
                            sp.add_event("shard.failover",
                                         endpoint=ep.target, reason=reason,
                                         error=str(exc))
                            if member:
                                self._note_endpoint_down(ep)
                        else:
                            # Non-transient (pattern mismatch, bad
                            # request, auth): the same bug on every
                            # endpoint — propagate, do not failover.
                            fatal = fatal or exc
                    if winner is not None:
                        # A valid verdict beats a loser's error — even a
                        # non-transient one (a hedge sibling's pattern
                        # mismatch / auth failure is per-endpoint in a
                        # heterogeneous fleet; the next dispatch routed
                        # to it will surface it on its own).
                        if self._m_batches is not None:
                            self._m_batches.labels(
                                endpoint=tasks[winner].target).inc()
                        sp.set_attr("winner", tasks[winner].target)
                        return await winner  # done: resolves immediately
                    if fatal is not None:
                        raise fatal
                raise Unavailable(
                    f"all {len(self._endpoints)} filterd endpoint(s) "
                    f"unavailable for {what}: "
                    + ("; ".join(errors)
                       or "no routable endpoint (unverified or "
                          "quarantined pattern sets)"))
            finally:
                live = [t for t in tasks if not t.done()]
                for t in live:
                    t.cancel()
                for t in live:
                    try:
                        await t
                    except (asyncio.CancelledError, Exception):  # noqa: BLE001
                        pass  # loser teardown; its outcome is irrelevant

    # -- client API ---------------------------------------------------

    async def hello(self) -> dict:
        return await self._dispatch(lambda c: c.hello(), "hello")

    async def match(self, lines: "list[bytes]") -> "list[bool]":
        result = await self._dispatch(lambda c: c.match(lines), "match")
        return result

    async def match_framed(self, payload: bytes, offsets: Any) -> Any:
        return await self._dispatch(
            lambda c: c.match_framed(payload, offsets), "match_framed")

    async def verify_patterns(self, patterns: "list[str]",
                              ignore_case: bool = False,
                              exclude: "list[str] | None" = None) -> None:
        """Startup handshake against EVERY endpoint: any reachable
        server with a drifted pattern set fails the run (a mismatched
        shard would silently mis-filter every batch routed to it); an
        unreachable server is warned about, excluded from routing, and
        re-verified by the background prober when it comes back — a
        partial fleet must not block startup, surviving one is the
        point of this tier. All-down is a hard error. Hello responses
        also teach the prober where each endpoint's /readyz lives."""
        if self._resolver is not None and not self._endpoints:
            # Resolver-seeded fleet (no --remote list): the FIRST
            # membership fill must succeed — there is nothing to keep
            # flying on. Applied before _expected is armed, so these
            # seeds are verified by the handshake below, exactly like
            # a static list.
            try:
                targets = await self._resolver.resolve()
            except Exception as e:  # noqa: BLE001
                raise Unavailable(
                    f"endpoint resolver {self._resolver.describe()} "
                    f"failed at startup: {e}") from e
            await self.apply_membership(targets)
            if not self._endpoints:
                raise Unavailable(
                    f"endpoint resolver {self._resolver.describe()} "
                    "returned no endpoints at startup")
        self._expected = (list(patterns), bool(ignore_case),
                          list(exclude or []))
        # Concurrent: each hello still gets its client's full retry
        # budget (a startup blip deserves patience), but the fleet pays
        # the MAX of the towers, not the sum — one black-holing node
        # costs what a single-endpoint setup would, never minutes per
        # dead endpoint.
        infos = await asyncio.gather(
            *[ep.client.hello() for ep in self._endpoints],
            return_exceptions=True)
        down: "list[str]" = []
        reachable = 0
        to_register: "list[_Endpoint]" = []
        for ep, info in zip(self._endpoints, infos):
            if isinstance(info, Unavailable):
                down.append(f"{ep.target}: {info}")
                ep.verified = False
                if self._m_ready is not None:
                    # The gauge promises "0 = draining or unreachable";
                    # an endpoint excluded from routing must not scrape
                    # as ready.
                    self._m_ready.labels(endpoint=ep.target).set(0)
                term.warning(
                    "filterd %s unavailable at startup (%s); continuing "
                    "with the rest of the fleet (it rejoins once its "
                    "pattern set verifies)", ep.target, info)
                continue
            if isinstance(info, BaseException):
                # Non-transient (config/auth bug): the run cannot
                # sensibly start — propagate the first one.
                raise info
            reachable += 1
            if check_server_config(ep.target, info, patterns, ignore_case,
                                   exclude) == "register":
                # Multi-tenant registry endpoint: this collector's set
                # must be registered there before the first batch.
                to_register.append(ep)
            self._learn_readyz(ep, info)
            self._note_capacity(ep, info)
        if not reachable:
            raise Unavailable(
                "no filterd endpoint reachable at startup: "
                + "; ".join(down))
        if to_register:
            # Concurrent like the hellos: each endpoint pays its own
            # compile (content-addressed: usually a reuse), the fleet
            # pays the MAX, not the sum. An endpoint that died between
            # Hello and Register gets the same treatment as one down at
            # Hello — excluded until the prober late-verifies it; only
            # a non-transient failure (the collector's own set failing
            # to compile) aborts startup.
            results = await asyncio.gather(
                *[ep.client.ensure_registered(patterns, ignore_case,
                                              exclude=exclude)
                  for ep in to_register],
                return_exceptions=True)
            for ep, res in zip(to_register, results):
                if isinstance(res, Unavailable):
                    ep.verified = False
                    if self._m_ready is not None:
                        self._m_ready.labels(endpoint=ep.target).set(0)
                    term.warning(
                        "filterd %s went away before registration "
                        "completed (%s); continuing with the rest of "
                        "the fleet", ep.target, res)
                elif isinstance(res, BaseException):
                    raise res
        self._ensure_prober()

    async def refresh_capacity(self) -> None:
        """One fleet-wide capacity sweep (concurrent, bounded per
        endpoint): refresh every routable endpoint's klogs_fleet_
        endpoint_* series from a Hello NOW. The prober does this on
        its own cadence for long-lived runs; a short batch run calls
        it before its --stats-json exit dump so the fleet's
        offered/admitted totals still land — the last scrape."""
        if self._m_cap_head is None or self._expected is None:
            return
        await asyncio.gather(
            *[self._refresh_capacity(ep) for ep in self._endpoints
              if ep.verified and not ep.quarantined
              and ep.breaker.state != BREAKER_OPEN],
            return_exceptions=True)

    async def aclose(self) -> None:
        if self._probe_stop is not None:
            self._probe_stop.set()
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                # A prober that died on its own error must not abort
                # teardown — the per-endpoint channels still need
                # closing below.
                pass
            self._probe_task = None
        if self._member_tasks:
            # Retired-channel closes still in flight: settle them so no
            # task outlives the client (task_lifecycle discipline).
            await asyncio.gather(*list(self._member_tasks),
                                 return_exceptions=True)
            self._member_tasks.clear()
        if self._resolver is not None:
            try:
                await self._resolver.aclose()
            except Exception:  # noqa: BLE001
                pass  # discovery teardown must not mask pipeline close
        await asyncio.gather(
            *[ep.client.aclose() for ep in self._endpoints],
            return_exceptions=True)

    def close(self) -> None:
        if self._probe_stop is not None:
            self._probe_stop.set()
        if self._probe_task is not None:
            self._probe_task.cancel()
            self._probe_task = None
        for ep in self._endpoints:
            ep.client.close()

    # -- fleet capacity re-export -------------------------------------

    def _note_capacity(self, ep: _Endpoint, info: dict) -> None:
        """Fold one Hello's capacity advertisement into the per-
        endpoint klogs_fleet_endpoint_* families: headroom is a gauge
        (last advertised value), offered/admitted are counters
        advanced by the observed delta — a restarted server (total
        dropped) restarts its contribution from the new total rather
        than poisoning the series with a negative increment."""
        ep.cap_next = time.monotonic() + self._cap_refresh_s
        head = info.get("headroom")
        if isinstance(head, (int, float)) and not isinstance(head, bool):
            # Routing weight learns from every Hello (registry or not):
            # clamp to [0,1], then floor — a saturated endpoint still
            # gets a trickle (its Hello is how it advertises recovery).
            ep.weight = max(_WEIGHT_FLOOR, min(1.0, max(0.0, float(head))))
            ep.cap_at = time.monotonic()
        if self._m_cap_head is None:
            return
        if isinstance(head, (int, float)) and not isinstance(head, bool):
            self._m_cap_head.labels(endpoint=ep.target).set(float(head))
        for key, attr, fam in (
                ("fleet_offered_lines", "cap_offered", self._m_cap_off),
                ("fleet_admitted_lines", "cap_admitted", self._m_cap_adm)):
            total = info.get(key)
            if not isinstance(total, int) or isinstance(total, bool):
                continue
            last: "int | None" = getattr(ep, attr)
            if last is not None and last // 2 < total < last:
                # STALE, not a restart: two concurrent Hellos (prober
                # cadence racing the exit-dump sweep) can land out of
                # order, and re-counting a lifetime total as a fresh
                # delta would spike the HPA's shed-pressure rate by
                # the endpoint's whole history in one scrape. A real
                # restart collapses the total towards zero; a slightly
                # smaller total is the older in-flight answer — keep
                # the newer state.
                continue
            delta = total - last if (last is not None
                                     and total >= last) else total
            if delta > 0:
                fam.labels(endpoint=ep.target).inc(delta)
            setattr(ep, attr, total)

    async def _refresh_capacity(self, ep: _Endpoint) -> None:
        """Prober-cadence capacity refresh: one bounded Hello against a
        verified, breaker-closed endpoint. Still-down endpoints simply
        wait for the next cycle (their gauges keep the last advertised
        value; routing state is the prober's other jobs' concern)."""
        try:
            info = await asyncio.wait_for(ep.client.hello(),
                                          timeout=self._probe_timeout_s)
        except (Unavailable, asyncio.TimeoutError):
            ep.cap_next = time.monotonic() + self._cap_refresh_s
            return
        self._note_capacity(ep, info)

    # -- readiness drain ----------------------------------------------

    _LOOPBACK = frozenset({"127.0.0.1", "localhost", "::1"})

    def _learn_readyz(self, ep: _Endpoint, info: dict) -> None:
        port = info.get("metrics_port")
        if not port or ep.target.startswith("unix:"):
            return  # no sidecar advertised: breakers alone guard it
        grpc_host = ep.target.rpartition(":")[0]
        if grpc_host.startswith("[") and grpc_host.endswith("]"):
            grpc_host = grpc_host[1:-1]
        # Where is the advertised sidecar actually reachable? Older
        # servers omit metrics_host; assume the conservative loopback
        # default they ship with.
        mhost = str(info.get("metrics_host") or "127.0.0.1")
        if mhost in ("0.0.0.0", "::"):
            host = grpc_host  # wildcard bind: same host as the RPCs
        elif mhost in self._LOOPBACK:
            if grpc_host not in self._LOOPBACK:
                # Loopback-bound sidecar on a REMOTE node: probing
                # grpc_host:port would hit nothing (or a stranger) and
                # a refused probe would wrongly demote a healthy
                # server. Skip — breakers alone guard this endpoint.
                return
            host = grpc_host
        else:
            host = mhost  # explicit routable bind address
        ep.readyz = (host, int(port))

    def _ensure_prober(self) -> None:
        if (self._probe_task is None
                and (any(ep.readyz for ep in self._endpoints)
                     or any(not ep.verified for ep in self._endpoints)
                     or self._m_cap_head is not None
                     or self._resolver is not None)):
            if self._probe_stop is None:
                self._probe_stop = asyncio.Event()
            self._probe_task = asyncio.get_running_loop().create_task(
                self._probe_loop())

    def _set_ready(self, ep: _Endpoint, ready: bool) -> None:
        if ready != ep.ready:
            if ready:
                term.info("filterd %s is ready again; rejoining the "
                          "rotation", ep.target)
            else:
                term.warning("filterd %s is draining (/readyz not ok); "
                             "routing around it", ep.target)
        ep.ready = ready
        if self._m_ready is not None:
            self._m_ready.labels(endpoint=ep.target).set(1 if ready else 0)

    async def _probe_loop(self) -> None:
        """Poll each endpoint's /readyz on a fixed cadence, and retry
        the startup handshake for endpoints that were down when
        verify_patterns ran. Not a retry loop in the policy sense:
        outcomes only flip routing state, and the wait is the
        stop-aware poller idiom (wait_for on the stop event), so a
        teardown mid-interval returns immediately."""
        stop = self._probe_stop
        assert stop is not None  # created by _ensure_prober
        while not stop.is_set():
            if (self._resolver is not None
                    and time.monotonic() >= self._resolver_next):
                # Membership poll rides the prober cadence but keeps
                # its own (usually longer) interval.
                try:
                    await self._resolve_step()
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    # _resolve_step already swallows resolver failures;
                    # this guards apply_membership itself — a bug there
                    # must not kill drain/late-verify for the fleet.
                    term.warning("membership update failed: %s", e)
            for ep in list(self._endpoints):
                if stop.is_set() or ep.quarantined:
                    continue
                if self._m_weight is not None:
                    # Exported weight is the EFFECTIVE one (decay
                    # applied) — what routing actually uses right now.
                    self._m_weight.labels(endpoint=ep.target).set(
                        self._effective_weight(ep, time.monotonic()))
                try:
                    if not ep.verified:
                        await self._late_verify(ep)
                    elif ep.readyz is not None:
                        self._set_ready(ep, await self._probe_ready(ep))
                    if (self._m_cap_head is not None
                            and self._expected is not None
                            and ep.verified
                            and ep.breaker.state != BREAKER_OPEN
                            and time.monotonic() >= ep.cap_next):
                        # Capacity re-export cadence: refresh this
                        # endpoint's headroom/offered/admitted gauges
                        # from a bounded Hello (KLOGS_FLEET_REFRESH_S).
                        await self._refresh_capacity(ep)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001
                    # A surprise here (e.g. a deleted token file turning
                    # hello into ServiceConfigError) must not kill the
                    # prober silently — drain and late-verify for the
                    # whole fleet would stop for the rest of the run.
                    term.warning("filterd %s health probe failed: %s",
                                 ep.target, e)
            try:
                await asyncio.wait_for(stop.wait(),
                                       timeout=self._probe_interval_s)
            except asyncio.TimeoutError:
                pass

    async def _late_verify(self, ep: _Endpoint) -> None:
        """An endpoint that was down during verify_patterns came (or
        may have come) back: verify its pattern set before it gets a
        single batch. Matching set -> it joins the rotation (and its
        /readyz is learned); a DRIFTED set -> permanent quarantine with
        one loud error — a redeployed shard serving different patterns
        must never silently mis-filter its share of the stream."""
        assert self._expected is not None  # set by verify_patterns
        patterns, ignore_case, exclude = self._expected
        try:
            # Bounded, no patience: the inner client's full retry tower
            # (minutes against a black-holing node) would stall this
            # sequential probe loop — and with it /readyz drain for
            # every HEALTHY sibling. A handshake that cannot answer
            # within the probe budget is simply still down.
            info = await asyncio.wait_for(ep.client.hello(),
                                          timeout=self._probe_timeout_s)
        except (Unavailable, asyncio.TimeoutError):
            return  # still down; try again next probe cycle
        try:
            status = check_server_config(ep.target, info, patterns,
                                         ignore_case, exclude)
        except PatternMismatch as e:
            ep.quarantined = True
            if self._m_ready is not None:
                self._m_ready.labels(endpoint=ep.target).set(0)
            term.error(
                "filterd %s came back with a DRIFTED pattern set; "
                "quarantining it for the rest of the run (%s)",
                ep.target, e)
            return
        if status == "register":
            # A multi-set endpoint that restarted lost our
            # registration: re-register before routing to it. Bounded,
            # but with a compile-sized floor — a fresh registration IS
            # a compile, unlike the instant Hello above; a node that
            # cannot finish within the budget simply stays out until
            # the next cycle (registration is idempotent server-side).
            try:
                await asyncio.wait_for(
                    ep.client.ensure_registered(patterns, ignore_case,
                                                exclude=exclude),
                    timeout=max(self._probe_timeout_s, 10.0))
            except (Unavailable, asyncio.TimeoutError):
                return
        ep.verified = True
        if self._m_ready is not None:
            self._m_ready.labels(endpoint=ep.target).set(1 if ep.ready
                                                         else 0)
        self._learn_readyz(ep, info)
        self._note_capacity(ep, info)
        term.info("filterd %s verified; joining the rotation", ep.target)

    async def _probe_ready(self, ep: _Endpoint) -> bool:
        """One GET /readyz. 200 = ready; a 503 (draining/cold), refused
        connection, or timeout all mean 'do not route here' — exactly
        the kubelet's readiness semantics."""
        assert ep.readyz is not None
        host, port = ep.readyz
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port),
                self._probe_timeout_s)
        except (OSError, asyncio.TimeoutError):
            return False
        try:
            writer.write(b"GET /readyz HTTP/1.1\r\nHost: " +
                         host.encode() + b"\r\nConnection: close\r\n\r\n")
            await asyncio.wait_for(writer.drain(), self._probe_timeout_s)
            status = await asyncio.wait_for(reader.readline(),
                                            self._probe_timeout_s)
            parts = status.split()
            return len(parts) >= 2 and parts[1] == b"200"
        except (OSError, asyncio.TimeoutError):
            return False
        finally:
            writer.close()
            try:
                # Bounded: an unanswered close handshake would wedge
                # the prober coroutine forever mid-probe, freezing
                # drain detection for the WHOLE fleet (observed as a
                # rare suite-order hang; kubelet probes are bounded
                # end to end for the same reason).
                await asyncio.wait_for(writer.wait_closed(),
                                       self._probe_timeout_s)
            except (OSError, asyncio.TimeoutError):
                pass
