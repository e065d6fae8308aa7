"""Thread-safe metrics core: counters, gauges, histograms, a registry.

Counterpart of ``klogs_tpu/obs/metrics.py``. ``Counter``, ``Gauge`` and
``Histogram`` (fixed buckets plus a bounded reservoir, so exact
percentiles stay queryable in the process) are grouped into named
families with optional label children, owned by a ``Registry`` that the
Prometheus exposition (``obs/expo.py``) and the HTTP sidecar
(``obs/http.py``) walk.

- One lock per child, held only around the few-word update. The
  instrumentation rides per-batch code, never per-line code.
- Families are get-or-create by name; a second ``register`` with
  another type or label set raises.
- Names, types, help and buckets live in one table
  (``obs/inventory.py`` ``SPECS``): call sites say
  ``registry.family(name)`` and cannot drift from it.
"""

import random
import threading
import time
from typing import Any, Iterable

# Bounded reservoir per histogram child: constant memory over an
# unbounded series, p50/p99 still sound.
RESERVOIR_SIZE = 8192

# The latency histograms' shared bucket ladder (seconds).
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _percentile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    idx = min(len(xs) - 1, max(0, round(q / 100 * (len(xs) - 1))))
    return xs[idx]


class _Reservoir:
    """Bounded uniform sample over an unbounded series."""

    __slots__ = ("xs", "count", "_rng")

    def __init__(self) -> None:
        self.xs: list[float] = []
        self.count = 0
        self._rng = random.Random(0)

    def add(self, x: float) -> None:
        self.count += 1
        if len(self.xs) < RESERVOIR_SIZE:
            self.xs.append(x)
        else:  # reservoir sampling: uniform over every sample so far
            j = self._rng.randrange(self.count)
            if j < RESERVOIR_SIZE:
                self.xs[j] = x


class Counter:
    """Monotonic counter; a negative ``inc`` raises (a decreasing
    counter corrupts every rate() over it)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, active streams)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed buckets (the Prometheus exposition's cumulative ``le``
    counts) plus a bounded reservoir (the in-process percentiles of
    ``--stats``)."""

    def __init__(self, buckets: Iterable[float] = LATENCY_BUCKETS) -> None:
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.bucket_counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0
        self._reservoir = _Reservoir()
        # The last exemplar per bucket (index len(buckets) = +Inf): the
        # trace link an OpenMetrics scrape attaches to the bucket.
        self._exemplars: "dict[int, tuple[dict, float, float]]" = {}

    def observe(self, value: float,
                exemplar: "dict | None" = None) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            hit = len(self.buckets)  # +Inf
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.bucket_counts[i] += 1
                    hit = i
                    break
            if exemplar is not None:
                self._exemplars[hit] = (exemplar, value, time.time())
            self._reservoir.add(value)

    def exemplars(self) -> "dict[int, tuple[dict, float, float]]":
        """bucket index -> (labels, observed value, unix time); index
        len(buckets) is the +Inf bucket."""
        with self._lock:
            return dict(self._exemplars)

    def percentile(self, q: float) -> float:
        with self._lock:
            return _percentile(self._reservoir.xs, q)

    def snapshot(self) -> tuple[list[int], float, int]:
        """(per-bucket counts, sum, count), one consistent view."""
        with self._lock:
            return list(self.bucket_counts), self.sum, self.count


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric with zero or more label children.

    Without ``labelnames`` the family is its single child: ``inc``,
    ``set``, ``observe``, ``value``, ``count`` and ``percentile``
    delegate to a default child made at once, so the unlabeled family
    always exposes a (possibly zero) sample. With labelnames, children
    are made at the first ``labels(...)`` and the bare family refuses
    samples.
    """

    def __init__(self, name: str, mtype: str, help: str = "",
                 labelnames: tuple = (),
                 buckets: "Iterable[float] | None" = None) -> None:
        if mtype not in _TYPES:
            raise ValueError(f"unknown metric type {mtype!r}")
        self.name = name
        self.type = mtype
        self.help = help
        self.labelnames = tuple(labelnames)
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self) -> Any:
        if self.type == "histogram":
            return Histogram(self._buckets or LATENCY_BUCKETS)
        return _TYPES[self.type]()

    def labels(self, **labelvalues: object) -> Any:
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def remove(self, **labelvalues: object) -> bool:
        """Drop one labeled child and its series: for labels whose live
        count is bounded but whose values churn (a retired fleet
        endpoint, an evicted tenant set). False when it never existed."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            return self._children.pop(key, None) is not None

    def children(self) -> list:
        """(labelvalues, child) pairs, sorted: a stable exposition
        order whatever the order of observation."""
        with self._lock:
            return sorted(self._children.items())

    # -- the unlabeled family's delegation ---------------------------

    def _default(self) -> Any:
        try:
            return self._children[()]
        except KeyError:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                "use .labels(...)") from None

    def inc(self, amount: float = 1) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float,
                exemplar: "dict | None" = None) -> None:
        self._default().observe(value, exemplar=exemplar)

    def percentile(self, q: float) -> float:
        return self._default().percentile(q)

    @property
    def value(self) -> float:
        return self._default().value

    @property
    def count(self) -> int:
        return self._default().count


class Registry:
    """Named metric families: the unit a /metrics scrape reads. A run
    builds its own (``app.run_async``), so a second run in one process
    starts at zero; ``REGISTRY`` below is the process-wide default that
    standalone tools report into."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def register(self, name: str, mtype: str, help: str = "",
                 labelnames: tuple = (),
                 buckets: "Iterable[float] | None" = None) -> Family:
        """Get-or-create; the same name with another shape raises."""
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} already registered as {fam.type}"
                        f"{fam.labelnames}, requested {mtype}"
                        f"{tuple(labelnames)}")
                return fam
            fam = Family(name, mtype, help=help, labelnames=labelnames,
                         buckets=buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Family:
        return self.register(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Family:
        return self.register(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: "Iterable[float] | None" = None) -> Family:
        return self.register(name, "histogram", help, labelnames, buckets)

    def family(self, name: str) -> Family:
        """Get-or-create from the inventory (``obs/inventory.py``
        ``SPECS``): how instrumented modules obtain their metrics."""
        with self._lock:
            fam = self._families.get(name)
        if fam is not None:
            return fam
        from klogs_tpu_torch.obs.inventory import SPECS

        spec = SPECS.get(name)
        if spec is None:
            raise KeyError(
                f"metric {name!r} is not in obs.inventory.SPECS; add it "
                "there first")
        return self.register(name, spec["type"], help=spec["help"],
                             labelnames=spec.get("labels", ()),
                             buckets=spec.get("buckets"))

    def get(self, name: str) -> "Family | None":
        with self._lock:
            return self._families.get(name)

    def collect(self) -> list[Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]


# The process-wide registry: where the tuner's telemetry lands when no
# run's registry is passed.
REGISTRY = Registry()
