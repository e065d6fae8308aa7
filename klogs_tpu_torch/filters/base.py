"""LogFilter interface, pipeline statistics and framed-batch helpers.

Counterpart of ``klogs_tpu/filters/base.py``. A line "matches" when ANY
of the K patterns matches anywhere in it (``re.search`` semantics);
lines go in, one keep/drop verdict per line comes out, and only kept
lines reach the sink.

A "framed batch" is ``(payload: bytes, offsets: int32[n+1])``: one
contiguous buffer plus prefix sums instead of n ``bytes`` objects. The
helpers here are numpy only (the JAX package's native packer is not
part of the port). ``pack_framed_rows`` is kept as the counterpart of
the JAX package's; the engine cuts its rows on the device instead
(``ops/pack.py``).
"""

import abc
import threading
import time

import numpy as np

# Offsets ride int32; batches past this must be split upstream, never
# silently wrapped into negative offsets.
_INT32_MAX = 2**31 - 1


class FilterStats:
    """The pipeline numbers behind ``--stats``: lines in and matched,
    and three latency series kept apart so saturation can be told
    from engine time:

    - batch (end to end): the sink's await, enqueue -> verdicts;
    - queue: enqueue -> device dispatch (recorded by AsyncFilterService);
    - device: dispatch -> verdicts fetched (AsyncFilterService).

    On the gated path the engine also records what the gate let
    through (``record_prefilter``: lines, candidate lines, tiles, live
    tiles; ``record_sweep`` when the literal sweep made the gate), and
    ``pf_disabled_reason`` says why a requested pair-CNF gate is off.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.lines_in = 0
        self.lines_matched = 0
        self.batches = 0
        self._batch_s: list[float] = []
        self._queue_s: list[float] = []
        self._device_s: list[float] = []
        self.started_at = time.perf_counter()
        # lines_per_sec counts from the first batch's dispatch, not from
        # construction, so engine warm-up does not deflate short runs.
        self.first_batch_started_at: float | None = None
        self.pf_lines = 0
        self.pf_candidates = 0
        self.pf_tiles_total = 0
        self.pf_tiles_live = 0
        self.pf_disabled_reason: str | None = None
        self.sweep_batches = 0
        self.sweep_lines = 0
        self.sweep_candidates = 0

    def mark_batch_started(self, t: float | None = None) -> None:
        with self._lock:
            if self.first_batch_started_at is None:
                self.first_batch_started_at = (
                    t if t is not None else time.perf_counter())

    def record_batch(self, n_lines: int, n_matched: int,
                     latency_s: float) -> None:
        with self._lock:
            if self.first_batch_started_at is None:
                # Synchronous paths never mark a dispatch.
                self.first_batch_started_at = (
                    time.perf_counter() - latency_s)
            self.lines_in += n_lines
            self.lines_matched += n_matched
            self.batches += 1
            self._batch_s.append(latency_s)

    def record_prefilter(self, n_lines: int, n_candidates: int,
                         n_tiles: int, n_tiles_live: int) -> None:
        with self._lock:
            self.pf_lines += n_lines
            self.pf_candidates += n_candidates
            self.pf_tiles_total += n_tiles
            self.pf_tiles_live += n_tiles_live

    def record_sweep(self, n_lines: int, n_candidates: int) -> None:
        """One batch narrowed by the device literal sweep."""
        with self._lock:
            self.sweep_batches += 1
            self.sweep_lines += n_lines
            self.sweep_candidates += n_candidates

    def record_queue_wait(self, wait_s: float) -> None:
        with self._lock:
            self._queue_s.append(wait_s)

    def record_device_batch(self, latency_s: float) -> None:
        with self._lock:
            self._device_s.append(latency_s)

    @staticmethod
    def _pct(samples: list[float], q: float) -> float:
        return float(np.percentile(samples, q)) if samples else 0.0

    def percentile_latency_s(self, q: float) -> float:
        return self._pct(self._batch_s, q)

    def percentile_queue_s(self, q: float) -> float:
        return self._pct(self._queue_s, q)

    def percentile_device_s(self, q: float) -> float:
        return self._pct(self._device_s, q)

    @property
    def has_service_latencies(self) -> bool:
        return bool(self._device_s)

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
    count."""
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
    offsets[i+1]])."""
    if not isinstance(payload, bytes):
        payload = bytes(payload)
    o = np.asarray(offsets).tolist()
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
