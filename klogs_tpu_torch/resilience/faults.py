"""FaultInjector: the chaos layer over the guarded call sites.

Counterpart of ``klogs_tpu/resilience/faults.py``. A fault point is a
name wrapping a call that a recovery path guards, so an armed fault
drives the real path (retry, reconnect, error isolation) rather than a
test double. The port fires:

- ``kube.list_pods``   pod listing (cluster/kube.py, cluster/fake.py)
- ``kube.log_stream``  log-stream open (cluster/kube.py, cluster/fake.py)
- ``sink.write``       a file sink's write (runtime/sink.py)
- ``source.open``      a non-kube source's stream open (sources/replay.py,
                       archive.py, socket.py)
- ``source.read``      a non-kube source's chunk read (same sites; it
                       surfaces as SourceError)
- ``rpc.hello``        a remote filter client's Hello (service/client.py)
- ``rpc.match``        its Match and MatchFramed RPCs (both points fire
                       inside ``retry_call``, with the client's endpoint
                       as the target)
- ``resolver.watch``   every membership poll of the sharded tier's
                       resolver (service/resolver.py)
- ``tune.step``        each tick of the ``KLOGS_TUNE=auto`` controller
                       (ops/tune.py): the tick is skipped, the loop
                       goes on

Tests arm a point with ``FAULTS.arm(point, times=..., exc=...,
delay_s=...)``; operators use the ``KLOGS_FAULTS`` spec
(``FaultInjector.load_spec``), whose ``error`` faults raise
``InjectedFault``, which every guarded site treats as a transient
failure. A point may carry an ``@target`` (``point@host:port:error*``)
that fires only where the site passes that endpoint to ``fire``.

Sites check ``if FAULTS.active`` first, so a run with nothing armed
pays nothing per chunk. Each firing counts into
``klogs_faults_injected_total{point=...}`` when a registry is bound.
"""

import asyncio
import re
from dataclasses import dataclass
from typing import Callable

KNOWN_POINTS = frozenset({
    "rpc.match", "rpc.hello", "kube.list_pods", "kube.log_stream",
    "sink.write", "source.open", "source.read", "resolver.watch",
    "tune.step",
})


class InjectedFault(Exception):
    """Raised by env-spec ``error`` faults. Guarded call sites treat it
    as a transient failure of the wrapped operation."""


class FaultSpecError(ValueError):
    """Malformed KLOGS_FAULTS spec string."""


@dataclass
class _Rule:
    times: "int | None"  # remaining firings; None = forever
    exc: "Callable[[], BaseException] | None"
    delay_s: float = 0.0
    target: "str | None" = None  # endpoint qualifier; None = any


# One clause: point[@target]:action[*times]; action = error |
# error(msg) | delay(seconds). *N = N firings, bare * = every firing,
# absent = once. The target (an endpoint like host:port) may itself
# contain ':' — the non-greedy match plus the literal action
# alternatives keep the parse unambiguous.
_CLAUSE = re.compile(
    r"^(?P<point>[a-z_.]+)(?:@(?P<target>.+?))?:(?P<action>error|delay)"
    r"(?:\((?P<arg>[^)]*)\))?(?P<star>\*(?P<times>\d+)?)?$")


def _valid_target(target: str) -> bool:
    """The shape a target must have to ever match a fire() site:
    HOST:PORT or a unix socket path."""
    if target.startswith("unix:"):
        return len(target) > len("unix:")
    host, sep, port = target.rpartition(":")
    return bool(sep and host and port.isdigit() and 0 < int(port) < 65536)


class FaultInjector:
    def __init__(self) -> None:
        self._rules: "dict[str, list[_Rule]]" = {}
        self.counts: "dict[str, int]" = {}
        self._registry = None

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def bind_registry(self, registry) -> None:
        """Count firings into this run's registry (None detaches: the
        registry is a run's, the injector the process's)."""
        self._registry = registry

    def arm(self, point: str, *, times: "int | None" = 1,
            exc: "BaseException | Callable[[], BaseException] | None" = None,
            delay_s: float = 0.0, target: "str | None" = None) -> None:
        """Script ``point`` to misbehave on its next ``times`` firings
        (None: every firing). ``exc`` is an exception instance (raised
        again each firing) or a zero-argument factory; None with a
        delay is a latency-only fault. ``target`` restricts the rule to
        one endpoint."""
        factory = None
        if exc is not None:
            factory = exc if callable(exc) else (lambda e=exc: e)
        self._rules.setdefault(point, []).append(
            _Rule(times=times, exc=factory, delay_s=delay_s, target=target))

    def clear(self) -> None:
        self._rules.clear()
        self.counts.clear()

    def armed_targets(self) -> "set[str]":
        """The endpoints of the armed targeted rules."""
        return {r.target for rules in self._rules.values()
                for r in rules if r.target is not None}

    def load_spec(self, spec: str) -> None:
        """Parse a ``KLOGS_FAULTS`` spec and REPLACE the current script
        (the spec describes the whole scenario). Grammar, clauses
        separated by ``;`` or ``,``::

            point:error            raise InjectedFault once
            point:error(msg)*3     raise InjectedFault(msg), 3 firings
            point:delay(0.5)*      sleep 0.5s before EVERY firing
            point@host:port:error* ... only at one endpoint (sites
                                   that know theirs pass it to fire)

        An unknown point raises: a typo would otherwise be a chaos
        script that tests nothing.
        """
        rules: "dict[str, list[_Rule]]" = {}
        for raw in re.split(r"[;,]", spec):
            clause = raw.strip()
            if not clause:
                continue
            m = _CLAUSE.match(clause)
            if m is None:
                raise FaultSpecError(
                    f"bad fault clause {clause!r} (want "
                    "point[@endpoint]:error[(msg)][*N] or "
                    "point[@endpoint]:delay(seconds)[*N])")
            point = m.group("point")
            if point not in KNOWN_POINTS:
                raise FaultSpecError(
                    f"unknown fault point {point!r} (known: "
                    f"{', '.join(sorted(KNOWN_POINTS))})")
            target = m.group("target")
            if target is not None and not _valid_target(target):
                # A malformed target can never equal an endpoint passed
                # to fire(): the clause would test nothing.
                raise FaultSpecError(
                    f"bad fault target {target!r} in {clause!r} (want "
                    "HOST:PORT or unix:/path.sock)")
            if m.group("star") is None:
                times: "int | None" = 1
            elif m.group("times") is not None:
                times = int(m.group("times"))
            else:
                times = None  # bare '*': every firing
            arg = m.group("arg")
            if m.group("action") == "delay":
                try:
                    delay = float(arg) if arg else 0.0
                except ValueError as e:
                    raise FaultSpecError(
                        f"bad delay seconds in {clause!r}") from e
                rules.setdefault(point, []).append(
                    _Rule(times=times, exc=None, delay_s=delay,
                          target=target))
            else:
                msg = arg or f"injected fault at {point}"
                rules.setdefault(point, []).append(_Rule(
                    times=times, exc=(lambda m=msg: InjectedFault(m)),
                    target=target))
        self._rules = rules
        self.counts.clear()

    async def fire(self, point: str, target: "str | None" = None) -> None:
        """Apply the next armed rule of ``point`` (none: a no-op): count
        it, sleep its delay, raise its exception. ``target`` is the
        site's endpoint, when it has one: a targeted rule fires only
        where it matches."""
        rules = self._rules.get(point)
        if not rules:
            return
        for i, rule in enumerate(rules):
            if rule.target is None or rule.target == target:
                break
        else:
            return  # only rules scripted for OTHER endpoints remain
        if rule.times is not None:
            rule.times -= 1
            if rule.times <= 0:
                rules.pop(i)
                if not rules:
                    del self._rules[point]
        # A targeted firing counts under its qualified name.
        key = point if rule.target is None else f"{point}@{rule.target}"
        self.counts[key] = self.counts.get(key, 0) + 1
        if self._registry is not None:
            self._registry.family("klogs_faults_injected_total").labels(
                point=key).inc()
        if rule.delay_s:
            await asyncio.sleep(rule.delay_s)
        if rule.exc is not None:
            raise rule.exc()


# The process-wide injector every guarded site consults; app.run_async
# loads KLOGS_FAULTS into it at startup.
FAULTS = FaultInjector()
