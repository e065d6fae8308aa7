"""FakeCluster: hermetic, deterministic in-memory cluster backend.

Counterpart of ``klogs_tpu/cluster/fake.py``: synthetic namespaces, pods
and containers, deterministic log lines with timestamps from an
injectable clock, server-side since/tail/follow/previous/timestamps
semantics mirroring the kubelet's, chunked streams whose chunk
boundaries do not align with lines (like HTTP chunked transfer), and
per-container fault injection (open failure, mid-stream cut or error,
slow chunks). In follow mode a stream generates a new line every
``follow_interval_s`` until it is closed.
"""

import asyncio
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Callable

from klogs_tpu_torch.cluster.backend import ClusterBackend, LogStream, StreamError
from klogs_tpu_torch.cluster.types import (
    ContainerInfo,
    LogOptions,
    PodInfo,
    match_label_selector,
)

LEVELS = ("INFO", "DEBUG", "WARN", "ERROR")


def synthetic_line(pod: str, container: str, seq: int, ts: float) -> bytes:
    """One deterministic log line. The level cycles, so each level is a
    quarter of the lines; a few structured fields give patterns
    something realistic to match."""
    level = LEVELS[seq % len(LEVELS)]
    tstr = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts))
    return (
        f"{tstr} {level} pod={pod} container={container} seq={seq} "
        f"latency={(seq * 7) % 500}ms code={200 + (seq % 5) * 100} "
        f"msg=\"request {'failed' if level == 'ERROR' else 'handled'} "
        f"path=/api/v{seq % 3}/items\"\n"
    ).encode()


@dataclass
class Faults:
    """Per-container fault injection for failure-path tests."""

    fail_open: bool = False  # raise StreamError from open_log_stream
    cut_after_lines: int | None = None  # clean EOF after this many lines
    error_after_lines: int | None = None  # raise StreamError mid-stream
    chunk_delay_s: float = 0.0  # slow stream


@dataclass
class FakeContainer:
    name: str
    init: bool = False
    # Historical lines as (unix_ts, line_bytes), ts ascending.
    lines: list[tuple[float, bytes]] = field(default_factory=list)
    # Follow mode: a new line every interval until the stream closes.
    follow_interval_s: float = 0.01
    faults: Faults = field(default_factory=Faults)
    # Sequence number of the next generated line.
    next_seq: int = 0
    # History of the previous terminated instance; empty = none, and a
    # ``previous`` open fails as the apiserver's 400 does.
    previous_lines: list[tuple[float, bytes]] = field(default_factory=list)


@dataclass
class FakePod:
    info: PodInfo
    containers: dict[str, FakeContainer] = field(default_factory=dict)


class FakeLogStream(LogStream):
    """Chunked byte stream over the selected history, then (in follow
    mode) lines generated live until ``close``."""

    def __init__(self, container: FakeContainer, pod_name: str,
                 opts: LogOptions, clock: Callable[[], float],
                 chunk_size: int):
        self._c = container
        self._pod = pod_name
        self._opts = opts
        self._clock = clock
        self._chunk_size = chunk_size
        # Created at first use, on the running loop.
        self._closed: "asyncio.Event | None" = None

    def _closed_ev(self) -> asyncio.Event:
        if self._closed is None:
            self._closed = asyncio.Event()
        return self._closed

    async def close(self) -> None:
        self._closed_ev().set()

    def _since_time_cutoff(self) -> float | None:
        """``since_time`` (RFC3339 with a zone) as an epoch cutoff."""
        if self._opts.since_time is None:
            return None
        from datetime import datetime

        return datetime.fromisoformat(
            self._opts.since_time.replace("Z", "+00:00")).timestamp()

    def _stamp(self, ts: float, ln: bytes) -> bytes:
        """``timestamps``: an RFC3339Nano stamp and one space before the
        line, as the kubelet writes it."""
        if not self._opts.timestamps:
            return ln
        frac = int((ts % 1) * 1e9)
        stamp = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts))
        return f"{stamp}.{frac:09d}Z ".encode() + ln

    def _select_history(self) -> list[bytes]:
        lines = self._c.previous_lines if self._opts.previous else self._c.lines
        cutoff = self._since_time_cutoff()
        if cutoff is not None:
            lines = [(ts, ln) for ts, ln in lines if ts >= cutoff]
        if self._opts.since_seconds is not None:
            cutoff = self._clock() - self._opts.since_seconds
            lines = [(ts, ln) for ts, ln in lines if ts >= cutoff]
        if self._opts.tail_lines is not None and self._opts.tail_lines >= 0:
            lines = lines[len(lines) - min(self._opts.tail_lines, len(lines)):]
        return [self._stamp(ts, ln) for ts, ln in lines]

    def _read_error(self) -> StreamError:
        return StreamError(f"stream read error for {self._pod}/{self._c.name}")

    async def _chunks(self) -> AsyncIterator[bytes]:
        f = self._c.faults
        emitted = 0
        buf = bytearray()
        for ln in self._select_history():
            if f.cut_after_lines is not None and emitted >= f.cut_after_lines:
                if buf:
                    yield bytes(buf)
                return  # clean EOF mid-stream (premature end)
            if (f.error_after_lines is not None
                    and emitted >= f.error_after_lines):
                if buf:
                    yield bytes(buf)
                raise self._read_error()
            buf += ln
            emitted += 1
            while len(buf) >= self._chunk_size:
                chunk = bytes(buf[:self._chunk_size])
                del buf[:self._chunk_size]
                if f.chunk_delay_s:
                    await asyncio.sleep(f.chunk_delay_s)
                yield chunk
                if self._closed_ev().is_set():
                    return
        if buf:
            yield bytes(buf)
            buf.clear()

        if not self._opts.follow or self._opts.previous:
            return  # a terminated instance produces no new lines

        closed = self._closed_ev()
        while not closed.is_set():
            try:
                await asyncio.wait_for(closed.wait(),
                                       timeout=self._c.follow_interval_s)
                return
            except asyncio.TimeoutError:
                pass
            if f.cut_after_lines is not None and emitted >= f.cut_after_lines:
                return
            if (f.error_after_lines is not None
                    and emitted >= f.error_after_lines):
                raise self._read_error()
            seq = self._c.next_seq
            self._c.next_seq += 1
            now = self._clock()
            cutoff = self._since_time_cutoff()
            if cutoff is not None and now < cutoff:
                continue  # the since bound applies to followed lines too
            emitted += 1
            yield self._stamp(now, synthetic_line(self._pod, self._c.name,
                                                  seq, now))

    def __aiter__(self) -> AsyncIterator[bytes]:
        return self._chunks()


class FakeCluster(ClusterBackend):
    def __init__(self, context_name: str = "fake-context",
                 default_namespace: str = "default",
                 clock: Callable[[], float] = time.time,
                 chunk_size: int = 4096):
        self.context_name = context_name
        self.default_namespace = default_namespace
        self.clock = clock
        self.chunk_size = chunk_size
        # namespace -> pod name -> FakePod
        self.namespaces: dict[str, dict[str, FakePod]] = {}

    def add_namespace(self, name: str) -> None:
        self.namespaces.setdefault(name, {})

    def add_pod(self, namespace: str, name: str,
                containers: list[str] | None = None,
                init_containers: list[str] | None = None,
                labels: dict[str, str] | None = None, ready: bool = True,
                lines_per_container: int = 0,
                follow_interval_s: float = 0.01,
                line_spacing_s: float = 1.0) -> FakePod:
        self.add_namespace(namespace)
        containers = containers if containers is not None else ["main"]
        init_containers = init_containers or []
        info = PodInfo(
            name=name, namespace=namespace, labels=dict(labels or {}),
            ready=ready,
            containers=[ContainerInfo(c) for c in containers],
            init_containers=[ContainerInfo(c, init=True)
                             for c in init_containers])
        pod = FakePod(info=info)
        now = self.clock()
        for cname in init_containers + containers:
            fc = FakeContainer(name=cname, init=cname in init_containers,
                               follow_interval_s=follow_interval_s)
            # Spaced line_spacing_s apart, the newest at ~now.
            n = lines_per_container
            for i in range(n):
                ts = now - (n - 1 - i) * line_spacing_s
                fc.lines.append((ts, synthetic_line(name, cname, i, ts)))
            fc.next_seq = n
            pod.containers[cname] = fc
        self.namespaces[namespace][name] = pod
        return pod

    @classmethod
    def synthetic(cls, n_pods: int, n_containers: int = 1,
                  lines_per_container: int = 100, namespace: str = "default",
                  n_not_ready: int = 0,
                  labels_for: Callable[[int], dict[str, str]] | None = None,
                  follow_interval_s: float = 0.01,
                  **kw) -> "FakeCluster":
        """Deterministic synthetic cluster: pod-0000..pod-NNNN."""
        fc = cls(**kw)
        fc.add_namespace(namespace)
        for p in range(n_pods):
            labels = labels_for(p) if labels_for else {"app": f"app-{p % 4}"}
            fc.add_pod(namespace, f"pod-{p:04d}",
                       containers=[f"c{c}" for c in range(n_containers)],
                       labels=labels, ready=p >= n_not_ready,
                       lines_per_container=lines_per_container,
                       follow_interval_s=follow_interval_s)
        return fc

    def current_context(self) -> tuple[str, str]:
        return self.context_name, self.default_namespace

    async def list_namespaces(self) -> list[str]:
        return sorted(self.namespaces)

    async def namespace_exists(self, namespace: str) -> bool:
        return namespace in self.namespaces

    async def list_pods(self, namespace: str,
                        label_selector: str | None = None) -> list[PodInfo]:
        pods = self.namespaces.get(namespace, {})
        return [p.info for p in pods.values()
                if not label_selector
                or match_label_selector(p.info.labels, label_selector)]

    async def open_log_stream(self, namespace: str, pod: str,
                              opts: LogOptions) -> LogStream:
        try:
            fc = self.namespaces[namespace][pod].containers[opts.container]
        except KeyError as e:
            raise StreamError(
                f"container {opts.container!r} of pod {pod!r} "
                f"in namespace {namespace!r} not found") from e
        if fc.faults.fail_open:
            raise StreamError(
                f"error getting logs for container {opts.container}: "
                "injected")
        if opts.previous and not fc.previous_lines:
            raise StreamError(
                f"previous terminated container {opts.container!r} in pod "
                f"{pod!r} not found")
        return FakeLogStream(fc, pod, opts, self.clock, self.chunk_size)
