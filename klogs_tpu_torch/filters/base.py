"""LogFilter interface, pipeline statistics and framed-batch helpers.

Counterpart of ``klogs_tpu/filters/base.py``. A line "matches" when ANY
of the K patterns matches anywhere in it (``re.search`` semantics);
lines go in, one keep/drop verdict per line comes out, and only kept
lines reach the sink.

A "framed batch" is ``(payload: bytes, offsets: int32[n+1])``: one
contiguous buffer plus prefix sums instead of n ``bytes`` objects.
``frame_lines`` and ``split_frame`` run on the port's C
(``native/_hostops.c``); ``frame_lines_plain`` and ``split_frame_plain``
are their numpy versions, which only the tests call.
``pack_framed_rows`` is kept as the counterpart of the JAX package's;
the engine cuts its rows on the device instead (``ops/pack.py``).
"""

import abc
import threading
import time

import numpy as np

from klogs_tpu_torch.native import hostops

# Offsets ride int32; batches past this must be split upstream, never
# silently wrapped into negative offsets.
_INT32_MAX = 2**31 - 1


class FilterStats:
    """The pipeline numbers behind ``--stats``, as a view over a
    Registry: every number lives in a metric family (the objects a
    /metrics scrape and the ``--stats-json`` dump read), so the summary
    and the scrape cannot disagree. By default each FilterStats owns a
    private Registry; ``app.run_async`` passes the run's own when
    ``--metrics-port`` or ``--stats-json`` asks for one.

    Three latency series are kept apart so saturation can be told from
    engine time:

    - batch (end to end): the sink's await, enqueue -> verdicts;
    - queue: enqueue -> device dispatch (recorded by AsyncFilterService);
    - device: dispatch -> verdicts fetched (AsyncFilterService).

    On the gated path the engine also records what the gate let
    through (``record_prefilter``: lines, candidate lines, tiles, live
    tiles; ``record_sweep`` when the literal sweep made the gate), and
    ``pf_disabled_reason`` says why a requested pair-CNF gate is off.
    """

    def __init__(self, registry=None):
        from klogs_tpu_torch.obs.metrics import Registry

        self.registry = registry if registry is not None else Registry()
        r = self.registry
        self._lines_in = r.family("klogs_sink_lines_total")
        self._lines_matched = r.family("klogs_sink_lines_matched_total")
        self._bytes_in = r.family("klogs_sink_bytes_in_total")
        self._bytes_out = r.family("klogs_sink_bytes_out_total")
        self._batches = r.family("klogs_sink_batches_total")
        self._deadline_flushes = r.family("klogs_sink_deadline_flush_total")
        self._batch = r.family("klogs_sink_batch_latency_seconds")
        self._queue = r.family("klogs_coalescer_queue_wait_seconds")
        self._device = r.family("klogs_engine_device_batch_seconds")
        self._pf_lines = r.family("klogs_engine_prefilter_lines_total")
        self._pf_candidates = r.family(
            "klogs_engine_prefilter_candidates_total")
        self._pf_tiles = r.family("klogs_engine_prefilter_tiles_total")
        self._pf_tiles_live = r.family(
            "klogs_engine_prefilter_tiles_live_total")
        self._compiles = r.family("klogs_engine_compile_total")
        self._bucket_width = r.family("klogs_engine_bucket_width_bytes")
        self._pad_bytes = r.family("klogs_engine_pad_bytes_total")
        self._payload_bytes = r.family("klogs_engine_payload_bytes_total")
        self._sweep_batches = r.family("klogs_sweep_batches_total")
        self._sweep_lines = r.family("klogs_sweep_lines_total")
        self._sweep_cand = r.family("klogs_sweep_candidate_lines_total")
        self._degraded_batches = r.family(
            "klogs_filter_degraded_batches_total")
        self._degraded_lines = r.family(
            "klogs_filter_degraded_lines_total")
        self.pf_disabled_reason: str | None = None
        self.started_at = time.perf_counter()
        # lines_per_sec counts from the first batch's dispatch, not from
        # construction, so engine warm-up does not deflate short runs.
        # The first write races between the dispatch loop and
        # synchronous record_batch callers, hence the lock.
        self._t_lock = threading.Lock()
        self.first_batch_started_at: float | None = None

    # -- counter views -------------------------------------------------

    @property
    def lines_in(self) -> int:
        return int(self._lines_in.value)

    @property
    def lines_matched(self) -> int:
        return int(self._lines_matched.value)

    @property
    def bytes_in(self) -> int:
        return int(self._bytes_in.value)

    @property
    def bytes_out(self) -> int:
        return int(self._bytes_out.value)

    @property
    def batches(self) -> int:
        return int(self._batches.value)

    @property
    def deadline_flushes(self) -> int:
        return int(self._deadline_flushes.value)

    @property
    def degraded_lines(self) -> int:
        """Lines that took any degrade action, summed over actions."""
        return int(sum(child.value
                       for _lv, child in self._degraded_lines.children()))

    @property
    def pf_lines(self) -> int:
        return int(self._pf_lines.value)

    @property
    def pf_candidates(self) -> int:
        return int(self._pf_candidates.value)

    @property
    def pf_tiles_total(self) -> int:
        return int(self._pf_tiles.value)

    @property
    def pf_tiles_live(self) -> int:
        return int(self._pf_tiles_live.value)

    @staticmethod
    def _sum(family) -> int:
        return int(sum(child.value for _lv, child in family.children()))

    @property
    def sweep_batches(self) -> int:
        return self._sum(self._sweep_batches)

    @property
    def sweep_lines(self) -> int:
        return self._sum(self._sweep_lines)

    @property
    def sweep_candidates(self) -> int:
        return self._sum(self._sweep_cand)

    # -- recording -----------------------------------------------------

    def mark_batch_started(self, t: float | None = None) -> None:
        """The first filtered batch's dispatch time (AsyncFilterService
        calls this at dispatch)."""
        with self._t_lock:
            if self.first_batch_started_at is None:
                self.first_batch_started_at = (
                    t if t is not None else time.perf_counter())

    def record_batch(self, n_lines: int, n_matched: int, n_bytes_in: int,
                     n_bytes_out: int, latency_s: float) -> None:
        with self._t_lock:
            if self.first_batch_started_at is None:
                # Synchronous paths never mark a dispatch.
                self.first_batch_started_at = (
                    time.perf_counter() - latency_s)
        self._lines_in.inc(n_lines)
        self._lines_matched.inc(n_matched)
        self._bytes_in.inc(n_bytes_in)
        self._bytes_out.inc(n_bytes_out)
        self._batches.inc()
        # The exemplar links the latency sample to the batch's trace,
        # when one records it.
        from klogs_tpu_torch.obs.trace import TRACER

        self._batch.observe(latency_s, exemplar=TRACER.exemplar())

    def record_deadline_flush(self) -> None:
        """A flush forced by the follow-mode deadline (not batch size):
        the sign that sinks run latency-bound."""
        self._deadline_flushes.inc()

    def record_prefilter(self, n_lines: int, n_candidates: int,
                         n_tiles: int, n_tiles_live: int) -> None:
        self._pf_lines.inc(n_lines)
        self._pf_candidates.inc(n_candidates)
        self._pf_tiles.inc(n_tiles)
        self._pf_tiles_live.inc(n_tiles_live)

    def record_sweep(self, path: str, n_lines: int,
                     n_candidates: int) -> None:
        """One batch narrowed by the literal sweep; ``path`` is the stage
        that ran it (the port's sweep is the ``device`` one)."""
        self._sweep_batches.labels(path=path).inc()
        self._sweep_lines.labels(path=path).inc(n_lines)
        self._sweep_cand.labels(path=path).inc(n_candidates)

    def record_queue_wait(self, wait_s: float) -> None:
        self._queue.observe(wait_s)

    def record_device_batch(self, latency_s: float) -> None:
        from klogs_tpu_torch.obs.trace import TRACER

        self._device.observe(latency_s, exemplar=TRACER.exemplar())

    def record_degraded(self, action: str, n_lines: int) -> None:
        """One sink flush handled by the degrade policy instead of the
        filter: ``action`` is what happened to its lines."""
        self._degraded_batches.labels(action=action).inc()
        self._degraded_lines.labels(action=action).inc(n_lines)

    def record_engine_batch(self, width: int, rows: int,
                            payload_bytes: int) -> None:
        """One width-bucketed sub-batch on the device: the bucket width
        and the padding (bucketed rows x width less the payload)."""
        self._bucket_width.observe(width)
        self._payload_bytes.inc(payload_bytes)
        self._pad_bytes.inc(max(0, width * rows - payload_bytes))

    def record_compile(self, n: int = 1) -> None:
        """Kernel libraries built or loaded (``ops/_build.py``) by the
        engine's launches: the port's cold-start cost."""
        self._compiles.inc(n)

    # -- the summary ---------------------------------------------------

    def percentile_latency_s(self, q: float) -> float:
        return self._batch.percentile(q)

    def percentile_queue_s(self, q: float) -> float:
        return self._queue.percentile(q)

    def percentile_device_s(self, q: float) -> float:
        return self._device.percentile(q)

    @property
    def has_service_latencies(self) -> bool:
        return self._device.count > 0

    def lines_per_sec(self) -> float:
        start = (self.first_batch_started_at
                 if self.first_batch_started_at is not None
                 else self.started_at)
        elapsed = time.perf_counter() - start
        return self.lines_in / elapsed if elapsed > 0 else 0.0

    def matched_pct(self) -> float:
        return 100.0 * self.lines_matched / self.lines_in if self.lines_in else 0.0


def frame_lines(lines: list[bytes], strip_nl: bool = True):
    """list[bytes] -> (payload, offsets: int32[n+1], raw_total).
    Trailing-newline runs are stripped when ``strip_nl`` (the engines'
    ``rstrip(b"\\n")`` rule); ``raw_total`` is the unstripped byte
    count. One C pass; a payload past int32 raises OverflowError."""
    payload, offs, raw = hostops().frame_lines(lines, int(strip_nl))
    return payload, np.frombuffer(offs, dtype=np.int32), raw


def frame_lines_plain(lines: list[bytes], strip_nl: bool = True):
    """The numpy version of ``frame_lines``."""
    raw = sum(len(ln) for ln in lines)
    bodies = [ln.rstrip(b"\n") for ln in lines] if strip_nl else lines
    if raw > _INT32_MAX and sum(len(b) for b in bodies) > _INT32_MAX:
        raise OverflowError(
            f"framed batch payload (> {_INT32_MAX} bytes) exceeds "
            "int32 offsets; split the batch")
    offsets = np.zeros(len(lines) + 1, dtype=np.int32)
    if bodies:
        offsets[1:] = np.cumsum(
            np.fromiter((len(b) for b in bodies), np.int64, len(bodies)))
    return b"".join(bodies), offsets, raw


def pack_framed_rows(payload: bytes, offsets, width: int,
                     rows: "int | None" = None, sel=None, lens=None):
    """Framed batch -> ([rows, width] uint8 zero-padded rows, [B] int64
    lens): the ragged scatter that turns a contiguous payload into the
    row layout the device consumes, with no per-line object. ``rows`` >=
    B adds zero rows (batch bucketing). ``sel`` packs only those frame
    rows, in ``sel`` order; ``lens`` overrides the per-row byte counts
    (of the selected rows when ``sel`` is given), e.g. with trailing
    newlines stripped. Every line must fit ``width``."""
    offsets = np.asarray(offsets)
    starts = offsets[:-1].astype(np.int64)
    if sel is not None:
        starts = starts[sel]
        if lens is None:
            lens = np.diff(offsets).astype(np.int64)[sel]
    if lens is None:
        lens = np.diff(offsets).astype(np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    B = len(lens)
    if rows is None:
        rows = B
    batch = np.zeros((rows, width), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        arr = np.frombuffer(payload, dtype=np.uint8)
        ends = np.cumsum(lens)
        intra = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
        src = np.repeat(starts, lens) + intra
        row_base = np.arange(B, dtype=np.int64) * width
        batch.reshape(-1)[np.repeat(row_base, lens) + intra] = arr[src]
    return batch, lens


def split_frame(payload: bytes, offsets) -> list[bytes]:
    """Framed batch -> list[bytes] (line i = payload[offsets[i]:
    offsets[i+1]]), in C; offsets out of range raise ValueError."""
    return hostops().split_frame(
        payload, np.ascontiguousarray(offsets, dtype=np.int32),
        len(offsets) - 1)


def split_frame_plain(payload: bytes, offsets) -> list[bytes]:
    """The numpy version of ``split_frame``, with its check."""
    if not isinstance(payload, bytes):
        payload = bytes(payload)
    o = np.asarray(offsets).tolist()
    for lo, hi in zip(o, o[1:]):
        if lo < 0 or hi < lo or hi > len(payload):
            raise ValueError("split_frame: offsets out of range")
    return [payload[o[i]:o[i + 1]] for i in range(len(o) - 1)]


class LogFilter(abc.ABC):
    """K-pattern any-match line filter."""

    @abc.abstractmethod
    def match_lines(self, lines: list[bytes]) -> list[bool]:
        """One verdict per line; True = keep. Lines may or may not carry
        a trailing newline."""

    # Two-phase API: dispatch() enqueues a batch and returns a handle
    # without waiting for its verdicts; fetch() waits for them. The
    # default is synchronous.

    def dispatch(self, lines: list[bytes]):
        return self.match_lines(lines)

    def fetch(self, handle) -> list[bool]:
        return handle

    def dispatch_framed(self, payload: bytes, offsets):
        return self.dispatch(split_frame(payload, offsets))

    def fetch_framed(self, handle) -> np.ndarray:
        return np.asarray(self.fetch(handle), dtype=bool)

    def close(self) -> None:
        """Release engine resources."""


class IncludeExcludeFilter(LogFilter):
    """keep = (no include set OR include matches) AND NOT exclude
    matches. dispatch() submits BOTH sides before either is awaited, so
    the two automata run back to back on the device."""

    def __init__(self, include: "LogFilter | None", exclude: LogFilter):
        self.include = include
        self.exclude = exclude

    def match_lines(self, lines: list[bytes]) -> list[bool]:
        return self.fetch(self.dispatch(lines))

    def dispatch(self, lines: list[bytes]):
        hi = self.include.dispatch(lines) if self.include is not None else None
        return (hi, self.exclude.dispatch(lines))

    def fetch(self, handle) -> list[bool]:
        hi, he = handle
        ex = self.exclude.fetch(he)
        if hi is None:
            return [not e for e in ex]
        return [i and not e for i, e in zip(self.include.fetch(hi), ex)]

    def dispatch_framed(self, payload: bytes, offsets):
        hi = (self.include.dispatch_framed(payload, offsets)
              if self.include is not None else None)
        return (hi, self.exclude.dispatch_framed(payload, offsets))

    def fetch_framed(self, handle) -> np.ndarray:
        hi, he = handle
        ex = self.exclude.fetch_framed(he)
        if hi is None:
            return ~ex
        return self.include.fetch_framed(hi) & ~ex

    def close(self) -> None:
        if self.include is not None:
            self.include.close()
        self.exclude.close()


def build_include_exclude(builder, patterns: list[str],
                          exclude: "list[str] | None") -> LogFilter:
    """Compose include/exclude pattern sets over a single-engine
    ``builder(pats) -> LogFilter``. Raises when both sets are empty."""
    exclude = exclude or []
    if not patterns and not exclude:
        raise ValueError("need at least one include or exclude pattern")
    include = builder(patterns) if patterns else None
    if exclude:
        return IncludeExcludeFilter(include, builder(exclude))
    return include
