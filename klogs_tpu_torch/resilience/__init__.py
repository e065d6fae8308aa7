"""Failure handling: the retry and breaker policy, and the fault layer.

Counterpart of ``klogs_tpu/resilience``: ``RetryPolicy``, ``Deadline``,
``CircuitBreaker`` and ``retry_call`` (``policy.py``), and ``FAULTS``,
the injector of the ``KLOGS_FAULTS`` chaos scripts (``faults.py``).
"""

from klogs_tpu_torch.resilience.faults import (
    FAULTS,
    KNOWN_POINTS,
    FaultInjector,
    FaultSpecError,
    InjectedFault,
)
from klogs_tpu_torch.resilience.policy import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    BreakerOpen,
    CircuitBreaker,
    Deadline,
    RetryPolicy,
    Unavailable,
    retry_call,
)

__all__ = [
    "BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN", "BreakerOpen",
    "CircuitBreaker", "Deadline", "FAULTS", "FaultInjector",
    "FaultSpecError", "InjectedFault", "KNOWN_POINTS", "RetryPolicy",
    "Unavailable", "retry_call",
]
