"""Continuous pipeline utilization profiler.

Counterpart of the profiler half of ``klogs_tpu/obs/profiler.py``.
Spans say where one batch went and metrics how often things happened;
``PipelineProfiler`` says which stage is the bottleneck now. It folds
every finished span whose name is in the stage catalog (``STAGES``:
``source.read``, ``fanout.read`` -> ``coalescer.dispatch`` ->
``device.frame``/``kernel``/``fetch`` -> ``sink.write`` ...) into
per-stage busy-seconds and, on a periodic tick, derives each stage's
utilization (busy-seconds per wall-second over the tick's window,
divided by the trace sampling rate), samples the registered probes
(queue depth, in-flight slots, executor backlog, open streams), and
serves the result as ``/profile`` on the sidecar and, with
``--profile-json``, as one JSON line a tick. Off by default: until
``enable()`` runs its span sink is not installed, so a disabled
profiler costs nothing a span.

The fold rides the span stream (per batch, never per line) and costs a
dict lookup and two float adds a span; the utilization is computed at
tick time, once per ``KLOGS_PROFILE_INTERVAL_S``. The design budget of
the whole layer is under 2% of a run's throughput.

On the card the device works asynchronously: ``device.kernel`` times
the enqueue of a sub-batch's launches and ``device.fetch`` the wait
for its verdicts, so the device's own time shows in ``device.fetch``
(and in ``klogs_engine_device_batch_seconds``), not in
``device.kernel``.

``FleetCapacity`` is filterd's capacity accountant: offered against
admitted lines, their rolling rates, and a headroom in [0, 1] that every
Hello carries (``klogs_fleet_*`` with a registry). Its rate envelope is
``KLOGS_FLEET_CAPACITY_LPS``, else the live profiler's peak stage
utilization stands in, else there is none: the port has no operating
point of its own on the card yet, and the JAX package's
``OPERATING_POINT.json`` was measured on a TPU, so it is never read.
"""

import json
import os
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Callable

from klogs_tpu_torch.obs import trace as _trace

if TYPE_CHECKING:
    import asyncio

    from klogs_tpu_torch.obs.metrics import Registry

# The pipeline stage catalog: the span names the profiler folds, the
# same as the JAX package's (a fixed enum bounding the `stage` label of
# the klogs_profile_* families). The port emits no shard.*, tenant.*,
# mesh.*, device.sweep or device.groupscan span yet; filterd and its
# client emit rpc.server and rpc.client.
STAGES: "tuple[str, ...]" = (
    "source.read",
    "fanout.read",
    "sink.flush",
    "sink.write",
    "coalescer.dispatch",
    "shard.dispatch",
    "rpc.client",
    "rpc.server",
    "tenant.admit",
    "device.frame",
    "device.sweep",
    "device.groupscan",
    "device.kernel",
    "device.fetch",
    "mesh.dispatch",
)
_STAGE_SET = frozenset(STAGES)

DEFAULT_INTERVAL_S = 1.0
# The rolling window of the offered/admitted rates.
_CAPACITY_WINDOW_S = 30.0
# The least spacing of two samples of the capacity history.
_CAPACITY_SAMPLE_S = 0.5
# Fallback zero point for process uptime when /proc is unreadable.
_T0 = time.monotonic()


def _profile_sample_from_env(default: float) -> float:
    """KLOGS_PROFILE_SAMPLE: the trace-sampling rate the profiler asks
    for when enabled (0..1; 0 keeps profiling off even against
    --profile-json). A malformed value raises naming the variable."""
    from klogs_tpu_torch.utils.env import read as env_read

    raw = env_read("KLOGS_PROFILE_SAMPLE")
    if raw is None:
        return default
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(
            f"KLOGS_PROFILE_SAMPLE={raw!r}: expected a number in [0, 1]"
        ) from None
    if not 0.0 <= val <= 1.0:
        raise ValueError(
            f"KLOGS_PROFILE_SAMPLE={raw!r}: expected a number in [0, 1]")
    return val


def process_uptime_s() -> float:
    """Seconds since THIS process started (not since module import):
    /proc/self/stat field 22 is the start time in clock ticks since
    boot, /proc/uptime the seconds since boot. Falls back to the
    module-load zero point where /proc is unavailable."""
    try:
        with open("/proc/self/stat", "rb") as f:
            stat = f.read()
        with open("/proc/uptime", "rb") as f:
            boot_uptime = float(f.read().split()[0])
        # Fields after the parenthesized comm (which may contain
        # spaces): field 22 (1-based) = starttime, i.e. index 19 after
        # the closing paren.
        after = stat.rsplit(b")", 1)[1].split()
        start_ticks = int(after[19])
        hz = os.sysconf("SC_CLK_TCK")
        return max(0.0, boot_uptime - start_ticks / float(hz))
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T0


def process_rss_bytes() -> int:
    """Current resident set size in bytes (/proc/self/statm field 2 x
    page size); 0 where /proc is unavailable."""
    try:
        with open("/proc/self/statm", "rb") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def refresh_process_metrics(registry: "Registry | None") -> None:
    """Update the process gauges (klogs_process_uptime_seconds,
    klogs_process_rss_bytes): before each /metrics render (off the
    event loop), at the --stats-json dump and on every profiler
    tick."""
    if registry is None:
        return
    registry.family("klogs_process_uptime_seconds").set(process_uptime_s())
    registry.family("klogs_process_rss_bytes").set(process_rss_bytes())


class PipelineProfiler:
    """Per-stage busy-seconds over the finished-span stream.
    ``PROFILER`` below is the process-wide instance; until ``enable()``
    runs, ``on_span`` is not a tracer sink."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._enabled = False
        self._sample = 0.0
        self._interval_s = DEFAULT_INTERVAL_S
        self._t_enabled: "float | None" = None
        # stage -> [busy_s, span_count]; changed under _lock (spans
        # arrive from the loop and from the archive producer threads).
        self._stages: "dict[str, list[float]]" = {}
        # parent span_id -> the folded children's duration so far:
        # stages nest (sink.flush wraps coalescer.dispatch wraps
        # device.fetch), so each span folds its self time, its duration
        # less its folded children's, or the outermost wrapper would
        # always be the bottleneck. Entries whose parent never folds
        # are evicted oldest-first past a cap.
        self._child_busy: "dict[str, float]" = {}
        self._last_tick: "tuple[float, dict[str, float]] | None" = None
        self._last_doc: "dict[str, Any] | None" = None
        # The last tick window's utilization by stage.
        self._util: "dict[str, float]" = {}
        self._capacity: "FleetCapacity | None" = None
        self._probes: "dict[str, Callable[[], float]]" = {}
        self._json_lock = threading.Lock()
        self._json_path: "str | None" = None
        self._registry: "Registry | None" = None
        # (busy_s, spans) per stage already synced, so the counter
        # families advance by each tick's deltas.
        self._synced: "dict[str, tuple[float, int]]" = {}

    # -- configuration ------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, sample: "float | None" = None) -> bool:
        """Install the span-fold sink and raise the tracer's sampling
        rate to the profile's (unless KLOGS_TRACE_SAMPLE pins one).
        ``sample`` defaults to KLOGS_PROFILE_SAMPLE, else 1.0. Returns
        whether the profiler is on (KLOGS_PROFILE_SAMPLE=0 keeps it off
        even against --profile-json)."""
        rate = sample if sample is not None else _profile_sample_from_env(1.0)
        if rate <= 0.0:
            return self._enabled
        from klogs_tpu_torch.utils.env import positive_float

        # Checked here: a malformed interval raising later inside the
        # ticker task would end profiling silently.
        interval = positive_float("KLOGS_PROFILE_INTERVAL_S",
                                  DEFAULT_INTERVAL_S)
        with self._lock:
            self._enabled = True
            self._sample = rate
            self._interval_s = interval
            if self._t_enabled is None:
                self._t_enabled = time.perf_counter()
        _trace.TRACER.ensure_sample(rate)
        # Idempotent (trace.reset() drops every sink).
        _trace.TRACER.remove_sink(self.on_span)
        _trace.TRACER.add_sink(self.on_span)
        return True

    def maybe_enable(self) -> bool:
        """On when KLOGS_PROFILE_SAMPLE > 0."""
        rate = _profile_sample_from_env(0.0)
        if rate > 0.0:
            return self.enable(rate)
        return self._enabled

    def bind_registry(self, registry: "Registry | None") -> None:
        with self._lock:
            self._registry = registry
            self._synced = {}

    def attach_capacity(self, capacity: "FleetCapacity | None") -> None:
        """filterd's capacity accountant: /profile and the JSON lines
        then carry its block (a later server in the process rebinds)."""
        self._capacity = capacity

    def set_json_path(self, path: "str | None") -> None:
        """--profile-json PATH: append one JSON line per tick."""
        with self._json_lock:
            self._json_path = path

    def add_probe(self, name: str, fn: "Callable[[], float]") -> None:
        """Register a named sampler (queue depth, in-flight slots,
        executor backlog) read at each tick; the same name replaces the
        probe."""
        with self._lock:
            self._probes[name] = fn

    def remove_probe(self, name: str,
                     fn: "Callable[[], float] | None" = None) -> None:
        """Drop a probe; with ``fn`` given, only when it is still the
        registered one (a replaced probe belongs to its new owner)."""
        with self._lock:
            if fn is None or self._probes.get(name) is fn:
                self._probes.pop(name, None)

    def reset(self) -> None:
        """Disable, remove the sink and wipe every state."""
        _trace.TRACER.remove_sink(self.on_span)
        with self._lock:
            self._enabled = False
            self._sample = 0.0
            self._interval_s = DEFAULT_INTERVAL_S
            self._t_enabled = None
            self._stages = {}
            self._child_busy = {}
            self._last_tick = None
            self._last_doc = None
            self._util = {}
            self._probes = {}
            self._registry = None
            self._synced = {}
        self._capacity = None
        with self._json_lock:
            self._json_path = None

    # -- the span fold (tracer sink) ----------------------------------

    def on_span(self, doc: "dict[str, Any]") -> None:
        """Fold one finished span into its stage's self busy-seconds
        (its duration less its folded children's, which finish first
        and wait in ``_child_busy``): a few dict operations and float
        adds under a lock."""
        name = doc.get("name")
        if not self._enabled or name not in _STAGE_SET:
            return
        dur = doc.get("duration_s")
        if not isinstance(dur, (int, float)):
            return
        span_id = doc.get("span_id")
        parent_id = doc.get("parent_id")
        with self._lock:
            child = (self._child_busy.pop(span_id, 0.0)
                     if isinstance(span_id, str) else 0.0)
            if isinstance(parent_id, str):
                if len(self._child_busy) >= 4096:
                    # Orphans (a parent that never folds): drop the
                    # oldest half rather than grow.
                    for key in list(self._child_busy)[:2048]:
                        del self._child_busy[key]
                self._child_busy[parent_id] = (
                    self._child_busy.get(parent_id, 0.0) + float(dur))
            acc = self._stages.get(name)  # type: ignore[arg-type]
            if acc is None:
                acc = self._stages[name] = [0.0, 0]  # type: ignore[index]
            acc[0] += max(0.0, float(dur) - child)
            acc[1] += 1

    def max_utilization(self) -> "float | None":
        """The peak stage utilization over the last tick window (what
        ``FleetCapacity.headroom`` reads); None before the first window
        or when disabled."""
        with self._lock:
            if not self._enabled or not self._util:
                return None
            return max(self._util.values())

    # -- ticking ------------------------------------------------------

    def tick(self, io: bool = True) -> "dict[str, Any] | None":
        """One tick: the window's utilization, the probes, the metric
        families, and the snapshot doc stored (and, with
        --profile-json, appended). Returns the doc, or None when
        disabled. ``run_ticker`` runs it in a thread (the append and the
        /proc reads are file I/O); ``io=False`` (``profile_doc``'s
        on-demand path, on the loop) skips both."""
        if not self._enabled:
            return None
        now = time.perf_counter()
        with self._lock:
            stages = {k: (v[0], int(v[1])) for k, v in self._stages.items()}
            last = self._last_tick
            self._last_tick = (now, {k: b for k, (b, _) in stages.items()})
            t_enabled = self._t_enabled if self._t_enabled is not None else now
            probes = list(self._probes.items())
            registry = self._registry
        # Divided by the trace-sampling rate: at sample=s only a
        # fraction s of batches carry spans.
        rate = _trace.TRACER.sample_rate()
        util: "dict[str, float]" = {}
        if last is not None and now - last[0] > 0:
            dt = now - last[0]
            for k, (busy, _) in stages.items():
                util[k] = (busy - last[1].get(k, 0.0)) / dt / max(rate, 1e-9)
        with self._lock:
            self._util = util
        if registry is not None:
            self._sync_metrics(registry, stages, util)
            if io:
                refresh_process_metrics(registry)
        samples: "dict[str, float]" = {}
        for name, fn in probes:
            try:
                v = fn()
            except Exception:
                continue  # a broken probe must not end the tick
            if isinstance(v, (int, float)):
                samples[name] = float(v)
        bottleneck = (max(util, key=lambda k: util[k])
                      if any(v > 0 for v in util.values()) else None)
        doc: "dict[str, Any]" = {
            "t": time.time(),
            "enabled": True,
            "sample": rate,
            "wall_s": round(now - t_enabled, 6),
            "stages": {
                k: {"busy_s": round(b, 6), "spans": n,
                    "utilization": round(util.get(k, 0.0), 6)}
                for k, (b, n) in sorted(stages.items())},
            "samples": samples,
            "bottleneck": bottleneck,
        }
        cap = self._capacity
        if cap is not None:
            doc["capacity"] = cap.doc()
        with self._lock:
            self._last_doc = doc
        if io:
            with self._json_lock:
                path = self._json_path
                if path is not None:
                    try:
                        with open(path, "a", encoding="utf-8") as f:
                            f.write(json.dumps(doc) + "\n")
                    except OSError:
                        pass  # best-effort
        return doc

    def _sync_metrics(self, registry: "Registry",
                      stages: "dict[str, tuple[float, int]]",
                      util: "dict[str, float]") -> None:
        busy = registry.family("klogs_profile_stage_busy_seconds_total")
        spans = registry.family("klogs_profile_stage_spans_total")
        gauge = registry.family("klogs_profile_stage_utilization")
        with self._lock:
            synced = dict(self._synced)
            self._synced = {k: (b, n) for k, (b, n) in stages.items()}
        for k, (b, n) in stages.items():
            last_b, last_n = synced.get(k, (0.0, 0))
            if b > last_b:
                busy.labels(stage=k).inc(b - last_b)
            if n > last_n:
                spans.labels(stage=k).inc(n - last_n)
        for k, u in util.items():
            gauge.labels(stage=k).set(u)

    def profile_doc(self) -> "dict[str, Any]":
        """What GET /profile serves: the last tick's snapshot as it is
        (so the endpoint and the --profile-json stream agree), or one
        computed on demand before the first tick."""
        with self._lock:
            doc = self._last_doc
            enabled = self._enabled
        if doc is not None:
            return doc
        if not enabled:
            return {"enabled": False, "stages": {}, "samples": {},
                    "bottleneck": None}
        # On demand, on the event loop: no file append, no /proc read.
        return self.tick(io=False) or {"enabled": False}

    async def run_ticker(self, stop: "asyncio.Event",
                         interval_s: "float | None" = None) -> None:
        """The periodic tick (a background task on the run's loop),
        with a stop-aware wait and one last tick at teardown, so the
        JSON-lines file ends with the whole run. Each tick runs in a
        worker thread."""
        import asyncio

        # The interval was checked at enable time.
        period = (interval_s if interval_s is not None
                  else self._interval_s)
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=period)
                break
            except asyncio.TimeoutError:
                pass
            await asyncio.to_thread(self.tick)
        await asyncio.to_thread(self.tick)


class FleetCapacity:
    """Offered against admitted lines, and the headroom filterd
    advertises in Hello (``klogs_fleet_*`` with a registry).

    - *offered*: lines that entered a match RPC, the demand;
    - *admitted*: lines that got their verdicts, the service; offered
      less admitted over a window is the shed an autoscaler adds
      capacity for;
    - *headroom*, in [0, 1] by the trust of its signal (``headroom``):
      1 - admitted rate / envelope where the operator set one
      (``KLOGS_FLEET_CAPACITY_LPS``), else 1 - the live profiler's peak
      stage utilization, else the operating point's envelope (none yet
      on the card), else None: a guess would be worse than silence.
    """

    def __init__(self, registry: "Registry | None" = None,
                 envelope_lps: "float | None" = None,
                 profiler: "PipelineProfiler | None" = None) -> None:
        self._lock = threading.Lock()
        self._offered = 0
        self._admitted = 0
        # A first sample at construction: the first rate is measured
        # from the start, not from its own read.
        self._hist: "deque[tuple[float, int, int]]" = deque(
            [(time.monotonic(), 0, 0)])
        self._envelope = envelope_lps
        self._envelope_resolved = envelope_lps is not None
        self._envelope_from_ctor = envelope_lps is not None
        self._profiler = profiler
        self._m_offered: Any = None
        self._m_admitted: Any = None
        self._m_headroom: Any = None
        if registry is not None:
            self._m_offered = registry.family(
                "klogs_fleet_offered_lines_total")
            self._m_admitted = registry.family(
                "klogs_fleet_admitted_lines_total")
            self._m_headroom = registry.family("klogs_fleet_headroom")

    # -- accounting ---------------------------------------------------

    def note_offered(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._offered += n
        if self._m_offered is not None:
            self._m_offered.inc(n)

    def note_admitted(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._admitted += n
        if self._m_admitted is not None:
            self._m_admitted.inc(n)

    @property
    def offered(self) -> int:
        with self._lock:
            return self._offered

    @property
    def admitted(self) -> int:
        with self._lock:
            return self._admitted

    def _roll(self, now: float) -> None:
        with self._lock:
            if (not self._hist
                    or now - self._hist[-1][0] >= _CAPACITY_SAMPLE_S):
                self._hist.append((now, self._offered, self._admitted))
            while (len(self._hist) > 1
                   and now - self._hist[0][0] > _CAPACITY_WINDOW_S):
                self._hist.popleft()

    def rates(self) -> "tuple[float | None, float | None]":
        """(offered, admitted) lines/s over the rolling window: the live
        totals against the oldest sample kept, so a Hello between two
        samples reads a current rate. (None, None) until the first
        sample is half a spacing old."""
        now = time.monotonic()
        self._roll(now)
        with self._lock:
            if not self._hist:
                return None, None
            t0, off0, adm0 = self._hist[0]
            off1, adm1 = self._offered, self._admitted
        dt = now - t0
        if dt < _CAPACITY_SAMPLE_S / 2:
            return None, None
        return (off1 - off0) / dt, (adm1 - adm0) / dt

    # -- the signal ---------------------------------------------------

    def envelope_lps(self) -> "float | None":
        """The rate envelope: ``KLOGS_FLEET_CAPACITY_LPS`` when set (the
        deployment's own calibration), else the operating point's
        (``_operating_point_lps``: none on the card yet)."""
        from klogs_tpu_torch.utils.env import is_set, positive_float

        if is_set("KLOGS_FLEET_CAPACITY_LPS"):
            return positive_float("KLOGS_FLEET_CAPACITY_LPS", 0.0)
        if self._envelope_resolved:
            return self._envelope
        self._envelope_resolved = True
        self._envelope = _operating_point_lps()
        return self._envelope

    def headroom(self) -> "float | None":
        """1 - saturation, clamped to [0, 1], by the signal's trust:

        1. an explicit envelope (``KLOGS_FLEET_CAPACITY_LPS`` or the
           constructor's): 1 - admitted rate / envelope;
        2. else the profiler's peak stage utilization, clamped at 1
           (it counts concurrency: 16 RPCs in flight read > 1, which
           means saturated);
        3. else the operating point's envelope;
        4. else None."""
        from klogs_tpu_torch.utils.env import is_set

        explicit = (is_set("KLOGS_FLEET_CAPACITY_LPS")
                    or (self._envelope_resolved
                        and self._envelope is not None
                        and self._envelope_from_ctor))
        if explicit:
            cap = self.envelope_lps()
            if cap:
                # Before the window has aged the observed rate is ~0: a
                # fresh server advertises full headroom.
                _, admitted_lps = self.rates()
                return max(0.0, min(1.0,
                                    1.0 - (admitted_lps or 0.0) / cap))
        prof = self._profiler if self._profiler is not None else PROFILER
        util = prof.max_utilization()
        if util is not None:
            return max(0.0, 1.0 - min(1.0, util))
        cap = self.envelope_lps()
        if cap:
            _, admitted_lps = self.rates()
            return max(0.0, min(1.0, 1.0 - (admitted_lps or 0.0) / cap))
        return None

    def doc(self) -> "dict[str, Any]":
        """The capacity block of Hello (and of /profile)."""
        offered_lps, admitted_lps = self.rates()
        head = self.headroom()
        if self._m_headroom is not None and head is not None:
            self._m_headroom.set(head)
        with self._lock:
            offered, admitted = self._offered, self._admitted
        return {
            "offered_lines": offered,
            "admitted_lines": admitted,
            "offered_lps": (round(offered_lps, 1)
                            if offered_lps is not None else None),
            "admitted_lps": (round(admitted_lps, 1)
                             if admitted_lps is not None else None),
            "headroom": head,
        }


def _operating_point_lps() -> "float | None":
    """The best lines/s of the port's operating-point sweep on the card:
    None, since no such sweep is committed yet. The JAX package's
    ``OPERATING_POINT.json`` holds a TPU's rates and is not read."""
    return None


# The process-wide profiler: what --profile-json, /profile and the
# layers' probes use.
PROFILER = PipelineProfiler()
