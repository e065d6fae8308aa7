"""The port's access point for ``KLOGS_*`` environment variables.

The port reads only names the JAX package already documents
(``KLOGS_FAKE_PODS``/``_CONTAINERS``/``_LINES`` for ``--cluster fake``,
``KLOGS_MAX_PATTERN_POSITIONS`` in the compiler, ``KLOGS_WATCH_INTERVAL_S``
for ``--watch-new`` and follow-mode source discovery,
``KLOGS_BUILD_VERSION`` for ``-v``, and for the sources
``KLOGS_SOURCE_READAHEAD_MB``, ``KLOGS_REPLAY_RATE`` and
``KLOGS_SOCKET_MAX_CONNS``, for the observability and fault layers
``KLOGS_TRACE_SAMPLE``, ``KLOGS_FLIGHT_DIR``, ``KLOGS_PROFILE_SAMPLE``,
``KLOGS_PROFILE_INTERVAL_S`` and ``KLOGS_FAULTS``, for the pipeline's
operating point ``KLOGS_MAX_IN_FLIGHT``, ``KLOGS_COALESCE_LINES``,
``KLOGS_FETCH_WORKERS`` and the controller's ``KLOGS_TUNE``,
``KLOGS_TUNE_INTERVAL_S`` and ``KLOGS_TUNE_STEP``, for the remote filter
service ``KLOGS_REMOTE_TIMEOUT_S``,
``KLOGS_REMOTE_TLS_CA``/``_CERT``/``_KEY``,
``KLOGS_REMOTE_TOKEN_FILE``, ``KLOGS_TENANT_WEIGHT`` and
``KLOGS_FLEET_CAPACITY_LPS``, for the sharded tier ``KLOGS_HEDGE_S``,
``KLOGS_READYZ_INTERVAL_S``, ``KLOGS_RESOLVER_INTERVAL_S``,
``KLOGS_WEIGHT_DECAY_S`` and ``KLOGS_FLEET_REFRESH_S``, and for the
multi-set registry ``KLOGS_TENANT_MAX_SETS``, ``_QUOTA_LINES``,
``_IDLE_S`` and ``_SLOTS``, and for a mesh across processes
``KLOGS_COORDINATOR``, ``KLOGS_NUM_PROCESSES`` and ``KLOGS_PROCESS_ID``)
and adds none.
"""

import math
import os
import sys


def read(name: str, default: "str | None" = None) -> "str | None":
    """The raw environment read; every KLOGS_* name flows through here."""
    return os.environ.get(name, default)


def is_set(name: str) -> bool:
    """Whether the variable is present at all (``KLOGS_TRACE_SAMPLE=0``
    differs from an unset one)."""
    return os.environ.get(name) is not None


def positive_float(name: str, default: float,
                   exc: type = ValueError) -> float:
    """A positive finite float; zero, a negative, nan, inf or garbage
    raises ``exc`` naming the variable."""
    raw = read(name)
    if raw is None:
        return default
    try:
        value = float(raw)
        if not math.isfinite(value) or value <= 0:
            raise ValueError("must be positive and finite")
    except ValueError as e:
        raise exc(
            f"{name} must be a positive number, got {raw!r}") from e
    return value


def nonneg_float(name: str, default: float) -> float:
    """A finite float >= 0; a malformed value raises ValueError."""
    raw = read(name)
    if raw is None:
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r}: expected a number") from None
    if not math.isfinite(v) or v < 0:
        raise ValueError(f"{name}={raw!r}: expected a finite value >= 0")
    return v


def warn_positive_int(name: str, default: int) -> int:
    """A positive int; a malformed value warns on stderr and the default
    is used."""
    raw = read(name)
    if raw is None:
        return default
    try:
        val = int(raw)
    except ValueError:
        val = 0
    if val < 1:
        print(f"klogs: ignoring invalid {name}={raw!r} (want a positive "
              f"integer); using {default}", file=sys.stderr)
        return default
    return val


def warn_nonneg_float(name: str, default: float) -> float:
    """A finite float >= 0 (0 often means off); a malformed value warns
    on stderr and the default is used."""
    raw = read(name)
    if raw is None:
        return default
    try:
        val = float(raw)
        if not math.isfinite(val) or val < 0:
            raise ValueError
    except ValueError:
        print(f"klogs: ignoring invalid {name}={raw!r} (want a "
              f"non-negative number); using {default}", file=sys.stderr)
        return default
    return val
