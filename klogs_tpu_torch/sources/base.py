"""Source contract: where log bytes come from.

Counterpart of ``klogs_tpu/sources/base.py``. Files, archives and
sockets feed the same per-stream machinery as the kube path (fan-out
workers, filtered sinks, reconnect policy):

* ``SourceStream``: an async iterator of byte chunks and ``close()``;
  ``cluster.backend.LogStream`` subclasses it, so every backend stream
  conforms.
* ``SourceRef``: a stream's identity. ``group`` plays the pod's part
  (one output file per group and unit), ``unit`` the container's.
  ``ephemeral`` marks a stream whose end is its lifecycle (a socket
  peer hanging up), not a failure to reconnect.
* ``Source``: discover refs, open a stream per ref, close.
  ``sources.cluster.ClusterSource`` adapts a cluster backend.

Chunks should be cut at a newline (``rfind(b"\\n")`` and a carried
tail), which spares the framer a straddling line; the framer takes any
split, so the cut is for speed, not correctness.

``Source.metrics`` (``SourceMetrics``) counts into the
``klogs_source_*`` families once ``bind_registry`` gives it a run's
registry; until then it counts nothing.

This module imports nothing of ``cluster/`` at run time (``LogOptions``
only for type checking), so ``klogs_tpu_torch.sources`` imports first
without a cycle: ``cluster/backend.py`` imports this module, never the
other way round.
"""

from __future__ import annotations

import abc
import os
import re
from dataclasses import dataclass
from typing import TYPE_CHECKING, AsyncIterator

if TYPE_CHECKING:
    from klogs_tpu_torch.cluster.types import LogOptions
    from klogs_tpu_torch.obs.metrics import Registry


class SourceError(Exception):
    """Opening or reading a source stream failed.

    Carries the ``path`` and byte ``offset`` where the implementation
    knows them (a truncated gzip member names the archive and the
    compressed offset where decoding stopped)."""

    def __init__(self, msg: str, *, path: "str | None" = None,
                 offset: "int | None" = None) -> None:
        super().__init__(msg)
        self.path = path
        self.offset = offset


class SourceConfigError(SourceError):
    """A ``--source``/``--backfill`` spec is malformed or names a
    capability this installation lacks (zstd without the zstandard
    package). Raised before any stream opens."""


class SourceStream(abc.ABC):
    """One open byte stream. Async-iterate chunks; ``close()`` is
    idempotent and unblocks a pending ``__anext__``."""

    @abc.abstractmethod
    def __aiter__(self) -> AsyncIterator[bytes]:
        """Iterate raw log chunks until the stream ends."""

    @abc.abstractmethod
    async def close(self) -> None:
        """Release the stream. Safe to call twice."""

    async def __aenter__(self) -> "SourceStream":
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.close()


@dataclass(frozen=True)
class SourceRef:
    """A stream's address within a source: ``group``/``unit`` stand for
    pod/container in job planning and file names, ``target`` is the
    source's own address (a file path, a connection id), and an
    ``ephemeral`` stream is never reconnected."""

    kind: str
    group: str
    unit: str
    target: str = ""
    ephemeral: bool = False


class SourceMetrics:
    """A view over the ``klogs_source_*`` families; every method is a
    no-op until a registry is bound."""

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self._bytes: object = None
        self._rotations: object = None
        self._members: object = None
        self._errors: object = None
        self._conns: object = None

    def bind(self, registry: "Registry | None") -> None:
        if registry is None:
            return
        self._bytes = registry.family(
            "klogs_source_bytes_total").labels(kind=self.kind)
        self._rotations = registry.family("klogs_source_rotations_total")
        self._members = registry.family(
            "klogs_source_archive_members_total")
        self._errors = registry.family(
            "klogs_source_errors_total").labels(kind=self.kind)
        self._conns = registry.family("klogs_source_connections_total")

    def add_bytes(self, n: int) -> None:
        if self._bytes is not None:
            self._bytes.inc(n)  # type: ignore[attr-defined]

    def rotation(self) -> None:
        if self._rotations is not None:
            self._rotations.inc()  # type: ignore[attr-defined]

    def member(self) -> None:
        if self._members is not None:
            self._members.inc()  # type: ignore[attr-defined]

    def error(self) -> None:
        if self._errors is not None:
            self._errors.inc()  # type: ignore[attr-defined]

    def connection(self) -> None:
        if self._conns is not None:
            self._conns.inc()  # type: ignore[attr-defined]


async def fire_fault(point: str, metrics: SourceMetrics, target: str,
                     path: str) -> None:
    """Fire an armed ``source.open``/``source.read`` fault (``target``:
    the stream's group) as the SourceError the fan-out handles."""
    from klogs_tpu_torch.resilience.faults import FAULTS, InjectedFault

    if not FAULTS.active:
        return
    try:
        await FAULTS.fire(point, target=target)
    except InjectedFault as exc:
        metrics.error()
        raise SourceError(f"injected {point} fault: {exc}",
                          path=path) from exc


class Source(abc.ABC):
    """A place log streams come from.

    Lifecycle: ``start()`` (bind listeners, on the event loop, never in
    ``__init__``), ``discover()`` (the current refs; polled in follow
    mode, so new files and connections join live), ``open_stream`` per
    ref, ``close()``. Constructors create no asyncio primitive."""

    kind: str = "source"

    def __init__(self) -> None:
        self.metrics = SourceMetrics(self.kind)

    async def start(self) -> None:
        """One-time async setup (default: none)."""

    @abc.abstractmethod
    async def discover(self) -> "list[SourceRef]":
        """The streams available now."""

    @abc.abstractmethod
    async def open_stream(self, ref: SourceRef,
                          opts: "LogOptions") -> SourceStream:
        """Open one stream. Raises SourceError on failure."""

    async def close(self) -> None:
        """Release listeners and threads. Safe to call twice."""

    def bind_registry(self, registry: "Registry | None") -> None:
        """Count into a run's ``klogs_source_*`` families."""
        self.metrics.bind(registry)


_UNSAFE = re.compile(r"[^A-Za-z0-9._-]+")


def safe_group_name(path: str) -> str:
    """A file path collapsed into a pod-shaped group name (it becomes
    part of the output file's name, so no separators)."""
    name = _UNSAFE.sub("_", path.replace(os.sep, "_")).strip("_.")
    return name or "stream"
