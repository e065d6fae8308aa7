"""FakeCluster: hermetic, deterministic in-memory cluster backend.

Counterpart of ``klogs_tpu/cluster/fake.py`` (its non-follow half):
synthetic namespaces, pods and containers, deterministic log lines with
timestamps from an injectable clock, server-side since/tail semantics,
and chunked streams whose chunk boundaries do not align with lines
(like HTTP chunked transfer from the kubelet).
"""

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
class FakeContainer:
    name: str
    init: bool = False
    # Historical lines as (unix_ts, line_bytes), ts ascending.
    lines: list[tuple[float, bytes]] = field(default_factory=list)


@dataclass
class FakePod:
    info: PodInfo
    containers: dict[str, FakeContainer] = field(default_factory=dict)


class FakeLogStream(LogStream):
    """Chunked byte stream over a container's selected history."""

    def __init__(self, container: FakeContainer, opts: LogOptions,
                 clock: Callable[[], float], chunk_size: int):
        self._c = container
        self._opts = opts
        self._clock = clock
        self._chunk_size = chunk_size
        self._closed = False

    async def close(self) -> None:
        self._closed = True

    def _select_history(self) -> list[bytes]:
        lines = self._c.lines
        if self._opts.since_seconds is not None:
            cutoff = self._clock() - self._opts.since_seconds
            lines = [(ts, ln) for ts, ln in lines if ts >= cutoff]
        if self._opts.tail_lines is not None and self._opts.tail_lines >= 0:
            lines = lines[len(lines) - min(self._opts.tail_lines, len(lines)):]
        return [ln for _, ln in lines]

    async def _chunks(self) -> AsyncIterator[bytes]:
        data = b"".join(self._select_history())
        for i in range(0, len(data), self._chunk_size):
            if self._closed:
                return
            yield data[i:i + self._chunk_size]

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
            fc = FakeContainer(name=cname, init=cname in init_containers)
            # Spaced line_spacing_s apart, the newest at ~now.
            n = lines_per_container
            for i in range(n):
                ts = now - (n - 1 - i) * line_spacing_s
                fc.lines.append((ts, synthetic_line(name, cname, i, ts)))
            pod.containers[cname] = fc
        self.namespaces[namespace][name] = pod
        return pod

    @classmethod
    def synthetic(cls, n_pods: int, n_containers: int = 1,
                  lines_per_container: int = 100, namespace: str = "default",
                  n_not_ready: int = 0,
                  labels_for: Callable[[int], dict[str, str]] | None = None,
                  **kw) -> "FakeCluster":
        """Deterministic synthetic cluster: pod-0000..pod-NNNN."""
        fc = cls(**kw)
        fc.add_namespace(namespace)
        for p in range(n_pods):
            labels = labels_for(p) if labels_for else {"app": f"app-{p % 4}"}
            fc.add_pod(namespace, f"pod-{p:04d}",
                       containers=[f"c{c}" for c in range(n_containers)],
                       labels=labels, ready=p >= n_not_ready,
                       lines_per_container=lines_per_container)
        return fc

    def current_context(self) -> tuple[str, str]:
        return self.context_name, self.default_namespace

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
        return FakeLogStream(fc, opts, self.clock, self.chunk_size)
