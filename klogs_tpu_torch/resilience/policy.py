"""Policy core: retry with backoff and jitter, per-attempt deadlines,
and a three-state circuit breaker.

Counterpart of ``klogs_tpu/resilience/policy.py``. Everything here runs
on the one asyncio event loop the pipeline shares, so no locks are
needed. ``CircuitBreaker`` takes an injectable ``clock`` so
state-machine tests never sleep. With a registry bound, the breaker's
state is the ``klogs_breaker_state`` gauge and ``retry_call``'s retries
count into ``klogs_retry_attempts_total``; a breaker that opens adds a
``breaker.open`` event to the batch in flight and arms the flight
recorder.
"""

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from klogs_tpu_torch.cluster.backend import ClusterError


class Unavailable(ClusterError):
    """A policy-guarded call ultimately failed: retries exhausted or the
    breaker is open. A ClusterError, so the CLI prints one line."""


class BreakerOpen(Unavailable):
    """Fast-fail: the breaker is open, the call was never attempted."""


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: attempt ``i`` (0-based) waits
    ``min(base_s * multiplier**i, max_s)``, spread by ``jitter``
    (uniform ±fraction). ``max_attempts`` counts ALL tries including the
    first; retries are ``max_attempts - 1``."""

    max_attempts: int = 5
    base_s: float = 0.5
    max_s: float = 10.0
    multiplier: float = 2.0
    jitter: float = 0.1

    def delay_s(self, attempt: int) -> float:
        d = min(self.base_s * self.multiplier ** attempt, self.max_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * random.random() - 1.0)
        return max(0.0, d)

    def retries_left(self, attempt: int) -> bool:
        """True when attempt ``attempt`` (0-based) may be followed by
        another."""
        return attempt + 1 < self.max_attempts

    async def wait(self, delay_s: float,
                   stop: "asyncio.Event | None" = None) -> bool:
        """Sleep ``delay_s``, stop-aware. Returns False when ``stop``
        fired during the wait: the caller must abort, not retry."""
        if stop is None:
            await asyncio.sleep(delay_s)
            return True
        try:
            await asyncio.wait_for(stop.wait(), timeout=delay_s)
            return False
        except asyncio.TimeoutError:
            return True

    async def sleep(self, attempt: int,
                    stop: "asyncio.Event | None" = None) -> bool:
        """Backoff before the retry following attempt ``attempt``."""
        return await self.wait(self.delay_s(attempt), stop)


class Deadline:
    """Per-attempt time budget; pass ``remaining()`` to the transport's
    timeout."""

    def __init__(self, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._t0 = clock()

    def remaining(self) -> float:
        return max(0.0, self.timeout_s - (self._clock() - self._t0))

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


BREAKER_CLOSED = 0
BREAKER_OPEN = 1
BREAKER_HALF_OPEN = 2

_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_OPEN: "open",
                BREAKER_HALF_OPEN: "half-open"}


class CircuitBreaker:
    """``failure_threshold`` CONSECUTIVE failures open it; while open,
    ``allow()`` is False; after ``reset_timeout_s`` it half-opens and
    admits ``half_open_max`` probes: one probe success closes it, one
    probe failure re-opens it for another full window. Its state is
    ``klogs_breaker_state{breaker=name}`` (0 closed, 1 open, 2
    half-open) when a registry is bound."""

    def __init__(self, name: str = "rpc", failure_threshold: int = 5,
                 reset_timeout_s: float = 10.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max = half_open_max
        self._clock = clock
        self._state = BREAKER_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._gauge = None
        self.bind_registry(registry)

    def bind_registry(self, registry) -> None:
        if registry is not None:
            self._gauge = registry.family("klogs_breaker_state").labels(
                breaker=self.name)
            self._gauge.set(self._state)

    @property
    def state(self) -> int:
        self._maybe_half_open()
        return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    def _set_state(self, state: int) -> None:
        prev, self._state = self._state, state
        if self._gauge is not None:
            self._gauge.set(state)
        if state == BREAKER_OPEN and prev != BREAKER_OPEN:
            # The batch whose failure opened the breaker: annotate it and
            # arm a flight-recorder dump of its story (no-ops when
            # tracing is off).
            from klogs_tpu_torch.obs.trace import TRACER, flight_trigger

            TRACER.event("breaker.open", breaker=self.name)
            flight_trigger("breaker-open", breaker=self.name)

    def _maybe_half_open(self) -> None:
        if (self._state == BREAKER_OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._set_state(BREAKER_HALF_OPEN)
            self._probes_in_flight = 0

    def allow(self) -> bool:
        """May a call proceed now? Half-open admits at most
        ``half_open_max`` concurrent probes (counting this one)."""
        self._maybe_half_open()
        if self._state == BREAKER_CLOSED:
            return True
        if self._state == BREAKER_HALF_OPEN:
            if self._probes_in_flight < self.half_open_max:
                self._probes_in_flight += 1
                return True
            return False
        return False

    def release_probe(self) -> None:
        """Give back a half-open probe slot taken by ``allow()`` when the
        call ended in neither success nor a health-relevant failure."""
        if self._state == BREAKER_HALF_OPEN and self._probes_in_flight > 0:
            self._probes_in_flight -= 1

    def record_success(self) -> None:
        self._failures = 0
        if self._state != BREAKER_CLOSED:
            self._set_state(BREAKER_CLOSED)
        self._probes_in_flight = 0

    def record_failure(self) -> None:
        if self._state == BREAKER_HALF_OPEN:
            self._set_state(BREAKER_OPEN)
            self._opened_at = self._clock()
            self._probes_in_flight = 0
            return
        self._failures += 1
        if (self._state == BREAKER_CLOSED
                and self._failures >= self.failure_threshold):
            self._set_state(BREAKER_OPEN)
            self._opened_at = self._clock()


async def retry_call(
    fn: "Callable[[Optional[Deadline]], Awaitable]",
    *,
    policy: RetryPolicy,
    retryable: "Callable[[BaseException], bool]",
    site: str = "call",
    describe: "str | None" = None,
    breaker: "CircuitBreaker | None" = None,
    deadline_s: "float | None" = None,
    stop: "asyncio.Event | None" = None,
    fault_point: "str | None" = None,
    fault_target: "str | None" = None,
    registry=None,
) -> object:
    """``await fn(deadline)`` under the policy: the breaker gates each
    attempt (open -> BreakerOpen at once), an armed ``fault_point``
    fires before it (``fault_target`` is the endpoint handed to
    ``FAULTS.fire``), a ``retryable`` failure (an InjectedFault always
    is) records a breaker failure and backs off stop-aware, and
    exhaustion raises ``Unavailable`` chaining the last cause. Other
    exceptions propagate untouched and do not trip the breaker.
    ``site`` labels ``klogs_retry_attempts_total``; ``describe``
    (default ``site``) prefixes the Unavailable message."""
    from klogs_tpu_torch.resilience.faults import FAULTS, InjectedFault

    describe = describe if describe is not None else site
    retries = None
    if registry is not None:
        retries = registry.family("klogs_retry_attempts_total").labels(
            site=site)
    attempt = 0
    while True:
        if breaker is not None and not breaker.allow():
            raise BreakerOpen(
                f"{describe}: circuit breaker {breaker.name!r} is open "
                f"(retry after ~{breaker.reset_timeout_s:.0f}s)")
        try:
            if fault_point is not None and FAULTS.active:
                await FAULTS.fire(fault_point, fault_target)
            result = await fn(
                Deadline(deadline_s) if deadline_s is not None else None)
        except Exception as e:  # noqa: BLE001 - classified below
            if not (isinstance(e, InjectedFault) or retryable(e)):
                if breaker is not None:
                    breaker.release_probe()
                raise
            if breaker is not None:
                breaker.record_failure()
            if not policy.retries_left(attempt):
                raise Unavailable(
                    f"{describe}: {e} (after {attempt + 1} attempt"
                    f"{'s' if attempt else ''})") from e
            if retries is not None:
                retries.inc()
            if not await policy.sleep(attempt, stop):
                raise Unavailable(f"{describe}: stopped during retry "
                                  f"backoff ({e})") from e
            attempt += 1
            continue
        except BaseException:
            if breaker is not None:
                breaker.release_probe()
            raise
        if breaker is not None:
            breaker.record_success()
        return result
