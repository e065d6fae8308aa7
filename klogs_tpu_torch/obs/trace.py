"""Trace spans and the degrade flight recorder.

Counterpart of ``klogs_tpu/obs/trace.py``. Metrics say how often things
happened; a trace says where one batch went. A span covers one step of
a batch's life (``fanout.read`` -> ``sink.flush`` ->
``coalescer.dispatch`` -> ``device.frame``/``device.kernel``/
``device.fetch`` -> ``sink.write``, and ``source.read`` for the
non-kube sources), and the flight recorder turns a degrade event into
one JSON file holding the batch's whole story.

- **Head sampling, off by default.** ``KLOGS_TRACE_SAMPLE`` is the
  fraction of traces recorded (0..1), decided once at the trace's root
  and carried by its context, so a trace is whole or absent. At 0
  ``span()`` is a float compare that returns a no-op singleton.
- **Spans ride per-batch code, never per-line code.**
- **Task-safe context.** The current span lives in a ContextVar, which
  asyncio tasks inherit when created. Executor threads do not inherit
  it, so the await site owns a span (``device.fetch`` wraps the
  ``run_in_executor`` await).
- **Bounded.** Attributes, events, the finished-span ring and the
  recorder's ring have fixed caps.

``FlightRecorder`` keeps a ring of recent finished spans;
``trigger(reason)`` (breaker open, filter degrade, sweep fallback,
abort escalation) arms a dump written when the triggering trace's
local root span finishes, so it holds the batch's complete story.

A span records an exception that leaves its ``with`` block and lets it
go on: nothing here swallows an error of the code it times.
"""

import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Callable, Iterable

if TYPE_CHECKING:
    from klogs_tpu_torch.obs.metrics import Registry

# The metadata key carrying the W3C-style traceparent
# (00-<32hex trace>-<16hex span>-<2hex flags>) across a process hop.
TRACEPARENT_KEY = "klogs-traceparent"

# Bounds: per-span attribute count / value length, events per span,
# finished-span ring (feeds /traces and the recorder).
MAX_ATTRS = 32
MAX_ATTR_LEN = 256
MAX_EVENTS = 64
DEFAULT_RING = 4096

_SENTINEL = object()  # "parent not given" marker for start_span

# Trace and span ids come from a private PRNG seeded from the OS, so a
# caller seeding the global `random` cannot collide trace identities.
_IDS = random.Random()


def _sample_from_env() -> float:
    """KLOGS_TRACE_SAMPLE: the fraction of traces to record (0..1). A
    malformed value raises naming the variable."""
    from klogs_tpu_torch.utils.env import read as env_read

    raw = env_read("KLOGS_TRACE_SAMPLE")
    if raw is None:
        return 0.0
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(
            f"KLOGS_TRACE_SAMPLE={raw!r}: expected a number in [0, 1]"
        ) from None
    if not 0.0 <= val <= 1.0:
        raise ValueError(
            f"KLOGS_TRACE_SAMPLE={raw!r}: expected a number in [0, 1]")
    return val


class SpanContext:
    """What a child span (local, or across a process hop) needs to
    parent itself. ``remote`` marks a context extracted from wire
    metadata: a span parented under one is this process's root of the
    trace, where the flight recorder's story completes."""

    __slots__ = ("trace_id", "span_id", "sampled", "remote")

    def __init__(self, trace_id: int, span_id: int, sampled: bool,
                 remote: bool = False) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.remote = remote

    def traceparent(self) -> str:
        return (f"00-{self.trace_id:032x}-{self.span_id:016x}-"
                f"{'01' if self.sampled else '00'}")

    @classmethod
    def from_traceparent(cls, value: str) -> "SpanContext | None":
        parts = value.split("-")
        if len(parts) != 4:
            return None
        try:
            trace_id = int(parts[1], 16)
            span_id = int(parts[2], 16)
            flags = int(parts[3], 16)
        except ValueError:
            return None
        if len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return cls(trace_id, span_id, bool(flags & 1))


def _clip(value: object) -> object:
    if isinstance(value, (int, float, bool)) or value is None:
        return value
    s = str(value)
    return s if len(s) <= MAX_ATTR_LEN else s[:MAX_ATTR_LEN] + "…"


class Span:
    """One timed operation, held open by ``with tracer.span(...)``.
    ``__exit__`` records an escaping exception as status=error
    (CancelledError as status=cancelled), reports to the tracer and
    lets the exception go on.

    An unsampled span still enters the context (so the head decision
    reaches its children) but records nothing."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "sampled", "local_root", "root_span_id", "start_unix",
                 "_t0", "duration_s", "status", "attrs", "events",
                 "_token", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: "int | None", sampled: bool,
                 attrs: "dict[str, object] | None" = None,
                 local_root: bool = False,
                 root_span_id: "int | None" = None) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.local_root = local_root or parent_id is None
        # The span whose end completes this process's part of the
        # story (the flight recorder waits for it): self when a local
        # root, else inherited down the local chain.
        self.root_span_id = (span_id if self.local_root
                             else (root_span_id if root_span_id is not None
                                   else parent_id))
        self.start_unix = time.time() if sampled else 0.0
        self._t0 = time.perf_counter()
        self.duration_s: "float | None" = None
        self.status = "ok"
        self.attrs: "dict[str, object]" = {}
        self.events: "list[dict[str, object]]" = []
        self._token: "contextvars.Token[object] | None" = None
        self._ended = False
        if sampled and attrs:
            for k, v in attrs.items():
                self.set_attr(k, v)

    # -- recording ----------------------------------------------------

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def set_attr(self, key: str, value: object) -> None:
        if self.sampled and len(self.attrs) < MAX_ATTRS:
            self.attrs[key] = _clip(value)

    def add_event(self, name: str, **attrs: object) -> None:
        if self.sampled and len(self.events) < MAX_EVENTS:
            ev: "dict[str, object]" = {
                "name": name, "t_s": time.perf_counter() - self._t0}
            for k, v in attrs.items():
                ev[k] = _clip(v)
            self.events.append(ev)

    def set_status(self, status: str) -> None:
        if self.sampled:
            self.status = status

    def end(self) -> None:
        """Finish the span and report it; idempotent."""
        if self._ended:
            return
        self._ended = True
        self.duration_s = time.perf_counter() - self._t0
        if self.sampled:
            self._tracer._finish(self)

    # -- context management -------------------------------------------

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type: "type[BaseException] | None",
                 exc: "BaseException | None", tb: object) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        if exc is not None and self.sampled:
            import asyncio

            if isinstance(exc, asyncio.CancelledError):
                self.status = "cancelled"
            else:
                self.status = "error"
                self.set_attr("error", f"{type(exc).__name__}: {exc}")
        self.end()

    def to_dict(self) -> "dict[str, object]":
        return {
            "name": self.name,
            "trace_id": f"{self.trace_id:032x}",
            "span_id": f"{self.span_id:016x}",
            "parent_id": (None if self.parent_id is None
                          else f"{self.parent_id:016x}"),
            "local_root": self.local_root,
            "start_unix": self.start_unix,
            "duration_s": self.duration_s,
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class _NoopSpan:
    """The span when tracing is off: every method is a no-op and the
    context var is never touched."""

    __slots__ = ()
    sampled = False
    name = ""

    def context(self) -> None:
        return None

    def set_attr(self, key: str, value: object) -> None:
        pass

    def add_event(self, name: str, **attrs: object) -> None:
        pass

    def set_status(self, status: str) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass


NOOP_SPAN = _NoopSpan()

# The active span of the current task or thread. Module-level (a
# ContextVar is created once) and shared by every Tracer in the process.
_CURRENT: "contextvars.ContextVar[object]" = contextvars.ContextVar(
    "klogs_trace_current", default=None)


class Tracer:
    """Span factory and finished-span ring. ``TRACER`` below is the
    process-wide instance every instrumented module uses; the sample
    rate comes from ``KLOGS_TRACE_SAMPLE`` unless ``configure()``
    overrides it."""

    def __init__(self, sample: "float | None" = None,
                 ring: int = DEFAULT_RING) -> None:
        self._lock = threading.Lock()
        self._sample = sample
        self._ring: "deque[dict[str, object]]" = deque(maxlen=ring)
        self._sinks: "list[Callable[[dict[str, object]], None]]" = []
        self._json_lock = threading.Lock()
        self._json_path: "str | None" = None
        self._m_spans: Any = None

    # -- configuration ------------------------------------------------

    def _rate(self) -> float:
        if self._sample is None:
            self._sample = _sample_from_env()
        return self._sample

    @property
    def enabled(self) -> bool:
        return self._rate() > 0.0

    def configure(self, sample: "float | None" = None) -> None:
        """Override the sample rate (None: read the environment again at
        the next use)."""
        self._sample = sample

    def sample_rate(self) -> float:
        """The effective head-sampling rate: what the profiler divides
        observed busy-seconds by."""
        return self._rate()

    def ensure_sample(self, rate: float) -> None:
        """Raise the sampling rate to at least ``rate`` (the profiler
        folds spans) unless KLOGS_TRACE_SAMPLE pins one: an explicit
        rate, 0 included, wins."""
        from klogs_tpu_torch.utils.env import is_set

        if is_set("KLOGS_TRACE_SAMPLE"):
            return
        if rate > self._rate():
            self._sample = rate

    def enable_default(self) -> None:
        """Sample every trace unless KLOGS_TRACE_SAMPLE is set
        (``--trace-json``: an explicit rate, 0 included, wins)."""
        from klogs_tpu_torch.utils.env import is_set

        if not is_set("KLOGS_TRACE_SAMPLE"):
            self._sample = 1.0

    def bind_registry(self, registry: "Registry | None") -> None:
        self._m_spans = (registry.family("klogs_trace_spans_total")
                         if registry is not None else None)

    def reset(self, sample: "float | None" = None) -> None:
        """Drop every finished span, sink and file sink, then set the
        rate (None: the environment's)."""
        with self._lock:
            self._ring.clear()
            self._sinks = []
        with self._json_lock:
            self._json_path = None
        self._sample = sample
        self._m_spans = None

    # -- span creation ------------------------------------------------

    def start_span(self, name: str, parent: object = _SENTINEL,
                   **attrs: object) -> "Span | _NoopSpan":
        """Create a span. ``parent`` defaults to the current span; pass
        a ``SpanContext`` (a coalesced group's carrying member, or one
        extracted from wire metadata) or ``None`` for a new root.
        Returns the no-op singleton when nothing samples."""
        if parent is _SENTINEL:
            parent = _CURRENT.get()
        if parent is None:
            rate = self._rate()
            if rate <= 0.0:
                return NOOP_SPAN
            sampled = rate >= 1.0 or _IDS.random() < rate
            return Span(self, name, _IDS.getrandbits(128),
                        _IDS.getrandbits(64), None, sampled, attrs or None)
        root_id: "int | None" = None
        if isinstance(parent, Span):
            root_id = parent.root_span_id
            ctx: "SpanContext | None" = parent.context()
        elif isinstance(parent, _NoopSpan):
            ctx = None
        else:
            ctx = parent
        if ctx is None:
            return NOOP_SPAN
        assert isinstance(ctx, SpanContext)
        return Span(self, name, ctx.trace_id, _IDS.getrandbits(64),
                    ctx.span_id, ctx.sampled, attrs or None,
                    local_root=ctx.remote, root_span_id=root_id)

    # The idiomatic entry (`with tracer.span("name"):`).
    span = start_span

    def record_span(self, name: str, parent: object, start_unix: float,
                    duration_s: float, **attrs: object
                    ) -> "Span | _NoopSpan":
        """A finished span of work timed elsewhere (the card's own
        events, a wait measured before its span could open): ``start_unix``
        and ``duration_s`` as given, under ``parent`` (a ``Span`` or
        ``SpanContext``; ``None`` records nothing). Returns it, so
        children can parent under it; the no-op singleton when the
        parent does not sample."""
        if parent is None:
            return NOOP_SPAN
        sp = self.start_span(name, parent=parent, **attrs)
        if isinstance(sp, Span) and sp.sampled:
            sp.start_unix = start_unix
            sp.duration_s = duration_s
            sp._ended = True
            self._finish(sp)
        return sp

    def current_span(self) -> "Span | None":
        cur = _CURRENT.get()
        return cur if isinstance(cur, Span) else None

    def current_context(self) -> "SpanContext | None":
        cur = _CURRENT.get()
        return cur.context() if isinstance(cur, Span) else None

    def event(self, name: str, **attrs: object) -> None:
        """Add an event to the current span, if one is recording."""
        cur = _CURRENT.get()
        if isinstance(cur, Span):
            cur.add_event(name, **attrs)

    def exemplar(self) -> "dict[str, str] | None":
        """Exemplar labels ({trace_id, span_id}) of the current sampled
        span: a histogram observation's link to its trace."""
        cur = _CURRENT.get()
        if isinstance(cur, Span) and cur.sampled:
            return {"trace_id": f"{cur.trace_id:032x}",
                    "span_id": f"{cur.span_id:016x}"}
        return None

    # -- wire propagation ---------------------------------------------

    def inject(self) -> "tuple[tuple[str, str], ...]":
        """Metadata entries carrying the current span context (empty
        when nothing records)."""
        cur = _CURRENT.get()
        if isinstance(cur, Span) and cur.sampled:
            return ((TRACEPARENT_KEY, cur.context().traceparent()),)
        return ()

    def extract(self, metadata: "Iterable[tuple[str, str]] | None"
                ) -> "SpanContext | None":
        """The traceparent in ``metadata``, or None when absent or
        malformed."""
        if not metadata:
            return None
        for key, value in metadata:
            if key == TRACEPARENT_KEY and isinstance(value, str):
                ctx = SpanContext.from_traceparent(value)
                if ctx is not None:
                    # Crossed a process boundary: spans parented under
                    # it are this process's roots of the trace.
                    ctx.remote = True
                return ctx
        return None

    # -- finished spans -----------------------------------------------

    def _finish(self, span: Span) -> None:
        doc = span.to_dict()
        with self._lock:
            self._ring.append(doc)
            sinks = list(self._sinks)
        if self._m_spans is not None:
            self._m_spans.inc()
        path = self._json_path
        if path is not None:
            self._write_json(path, doc)
        for sink in sinks:
            try:
                sink(doc)
            except Exception:
                pass  # a broken trace sink must not end the run

    def _write_json(self, path: str, doc: "dict[str, object]") -> None:
        try:
            with self._json_lock:
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(doc) + "\n")
        except OSError:
            pass  # tracing is best-effort

    def add_sink(self, fn: "Callable[[dict[str, object]], None]") -> None:
        with self._lock:
            self._sinks.append(fn)

    def remove_sink(self, fn: "Callable[[dict[str, object]], None]"
                    ) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    def set_json_path(self, path: "str | None") -> None:
        """--trace-json PATH: append every finished span as one JSON
        line (the file twin of the /traces endpoint)."""
        with self._json_lock:
            self._json_path = path

    def finished_spans(self) -> "list[dict[str, object]]":
        with self._lock:
            return list(self._ring)

    def traces_doc(self) -> "dict[str, object]":
        """Finished spans grouped by trace for the /traces endpoint:
        {"traces": [{"trace_id", "spans": [...]}, ...]}, spans in start
        order, traces in first-seen order."""
        groups: "dict[str, list[dict[str, object]]]" = {}
        for doc in self.finished_spans():
            groups.setdefault(str(doc["trace_id"]), []).append(doc)
        traces = []
        for tid, spans in groups.items():
            spans.sort(key=lambda d: (d.get("start_unix") or 0.0))
            traces.append({"trace_id": tid, "spans": spans})
        return {"traces": traces}


class FlightRecorder:
    """A ring of recent spans, dumped as one JSON file when a degrade
    event fires. A tracer sink; ``trigger(reason)`` arms a dump written
    when the triggering chain's root span finishes. A per-reason rate
    limit keeps a flapping breaker from writing a dump a flap;
    ``flush()`` writes an armed dump at once (teardown)."""

    def __init__(self, capacity: int = 1024,
                 dir_path: "str | None" = None,
                 min_interval_s: float = 30.0) -> None:
        self._lock = threading.Lock()
        self._ring: "deque[dict[str, object]]" = deque(maxlen=capacity)
        self._dir = dir_path
        self._min_interval_s = min_interval_s
        self._last: "dict[str, float]" = {}
        self._pending: "list[dict[str, object]]" = []
        self._seq = 0
        self._writers: "list[threading.Thread]" = []
        self.dumps: "list[str]" = []
        self._m_dumps: Any = None

    def configure(self, dir_path: "str | None" = None,
                  min_interval_s: "float | None" = None) -> None:
        with self._lock:
            if dir_path is not None:
                self._dir = dir_path
            if min_interval_s is not None:
                self._min_interval_s = min_interval_s

    def bind_registry(self, registry: "Registry | None") -> None:
        self._m_dumps = (registry.family("klogs_flight_dumps_total")
                         if registry is not None else None)

    def reset(self) -> None:
        self.join_writes()
        with self._lock:
            self._ring.clear()
            self._pending = []
            self._last = {}
            self._writers = []
            self.dumps = []
        self._m_dumps = None

    def _dump_dir(self) -> str:
        if self._dir is not None:
            return self._dir
        from klogs_tpu_torch.utils.env import read as env_read

        env = env_read("KLOGS_FLIGHT_DIR")
        if env:
            return env
        import tempfile

        return tempfile.gettempdir()

    # -- span stream (tracer sink) ------------------------------------

    def record(self, doc: "dict[str, object]") -> None:
        pending = None
        with self._lock:
            self._ring.append(doc)
            if self._pending:
                # Write when the root span recorded at trigger time
                # finishes (the exact span, not just its trace: with
                # both ends of a hop in one process the inner local
                # root ends first). A trigger armed outside any trace
                # flushes on the next local root.
                wanted = {t.get("root_span_id") for t in self._pending}
                if ((None in wanted and doc.get("local_root"))
                        or doc.get("span_id") in wanted):
                    pending, self._pending = self._pending, []
        if pending is not None:
            self._write(pending)

    # -- triggers -----------------------------------------------------

    def trigger(self, reason: str, **attrs: object) -> None:
        """Arm a dump for ``reason`` (breaker-open, filter-degrade,
        sweep-fallback, abort-escalation). A no-op with no story to dump
        (no recording trace and an empty ring) or inside the reason's
        rate-limit window."""
        now = time.monotonic()
        # The dump waits for the local root of the chain that tripped
        # the trigger, not for whichever trace finishes first.
        cur = TRACER.current_span()
        if cur is not None and not cur.sampled:
            cur = None
        with self._lock:
            if cur is None and not self._ring and not self._pending:
                return
            last = self._last.get(reason)
            if last is not None and now - last < self._min_interval_s:
                return
            self._last[reason] = now
            entry: "dict[str, object]" = {"reason": reason,
                                          "wall": time.time()}
            entry["trace_id"] = (f"{cur.trace_id:032x}"
                                 if cur is not None else None)
            entry["root_span_id"] = (
                f"{cur.root_span_id:016x}"
                if cur is not None and cur.root_span_id is not None
                else None)
            for k, v in attrs.items():
                entry[k] = _clip(v)
            self._pending.append(entry)
            # Bounded: a trigger whose trace never completes must not
            # accumulate.
            if len(self._pending) > 32:
                del self._pending[0]

    def flush(self) -> "str | None":
        """Write an armed dump now (no root ends after teardown) and wait
        for the file; its path, or None when nothing was armed."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            self.join_writes()
            return None
        return self._write(pending, wait=True)

    def join_writes(self, timeout_s: float = 5.0) -> None:
        """Wait for the dump writes in flight."""
        with self._lock:
            writers = list(self._writers)
        for w in writers:
            w.join(timeout_s)

    def _write(self, triggers: "list[dict[str, object]]",
               wait: bool = False) -> "str | None":
        with self._lock:
            spans = list(self._ring)
            self._seq += 1
            seq = self._seq
        path = os.path.join(self._dump_dir(),
                            f"klogs-flight-{os.getpid()}-{seq}.json")
        # Serialization and disk I/O off the caller: record() runs on
        # the event loop, and a full ring is hundreds of KB. ``wait``
        # (teardown) joins before returning.
        worker = threading.Thread(
            target=self._write_blob, args=(triggers, spans, path),
            name="klogs-flight-dump", daemon=True)
        with self._lock:
            self._writers.append(worker)
            if len(self._writers) > 8:
                self._writers = [w for w in self._writers
                                 if w.is_alive()][-8:]
        worker.start()
        if wait:
            worker.join(5.0)
        return path

    def _write_blob(self, triggers: "list[dict[str, object]]",
                    spans: "list[dict[str, object]]", path: str) -> None:
        doc = {
            "reasons": triggers,
            "wall": time.time(),
            "pid": os.getpid(),
            "spans": spans,
        }
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
        except OSError as e:
            from klogs_tpu_torch.ui import term

            term.warning("cannot write flight-recorder dump %s: %s",
                         path, e)
            return
        with self._lock:
            self.dumps.append(path)
        if self._m_dumps is not None:
            for t in triggers:
                self._m_dumps.labels(reason=t["reason"]).inc()
        from klogs_tpu_torch.ui import term

        term.info("flight recorder dump (%s) written to %s",
                  ", ".join(str(t["reason"]) for t in triggers), path)


# The process-wide tracer and recorder (the recorder is a sink of the
# tracer's span stream).
TRACER = Tracer()
RECORDER = FlightRecorder()
TRACER.add_sink(RECORDER.record)


def flight_trigger(reason: str, **attrs: object) -> None:
    """The degrade sites' trigger (breaker open, filter degrade, sweep
    fallback, abort escalation); a no-op when tracing is off."""
    RECORDER.trigger(reason, **attrs)


def reset(sample: "float | None" = None) -> None:
    """Wipe the process-wide tracer and recorder, wire the recorder's
    sink again and set the sample rate (None: the environment's)."""
    TRACER.reset(sample)
    RECORDER.reset()
    TRACER.add_sink(RECORDER.record)
