"""ClusterBackend: the seam between the CLI and any cluster.

Counterpart of ``klogs_tpu/cluster/backend.py``. Everything above it
(pod selection, fan-out, filtering, sinks) talks to this interface, so
the hermetic FakeCluster serves every test and demo run. All methods are
async: the fan-out runs on one asyncio event loop. A backend's streams
follow the source contract (``sources/base.py``): ``LogStream`` is a
``SourceStream`` and ``StreamError`` a ``SourceError``, so the fan-out
handles kube, file and socket streams alike.
"""

import abc

from klogs_tpu_torch.cluster.types import LogOptions, PodInfo
from klogs_tpu_torch.sources.base import SourceError, SourceStream


class ClusterError(Exception):
    """A cluster-access failure (apiserver error analog)."""


class StreamError(ClusterError, SourceError):
    """Opening or reading a log stream failed."""


class LogStream(SourceStream):
    """One container's log stream: an async iterator of byte chunks whose
    boundaries need not align with lines (the iterator and ``close``
    contract of ``SourceStream``)."""


class ClusterBackend(abc.ABC):
    @abc.abstractmethod
    def current_context(self) -> tuple[str, str]:
        """(context_name, default_namespace)."""

    @abc.abstractmethod
    async def list_namespaces(self) -> list[str]:
        """Every namespace name (the namespace picker's options)."""

    @abc.abstractmethod
    async def namespace_exists(self, namespace: str) -> bool: ...

    @abc.abstractmethod
    async def list_pods(self, namespace: str,
                        label_selector: str | None = None) -> list[PodInfo]:
        """Every pod (ready or not) matching the selector; callers apply
        the Ready filter."""

    @abc.abstractmethod
    async def open_log_stream(self, namespace: str, pod: str,
                              opts: LogOptions) -> LogStream:
        """``opts.container`` must be set; since/tail/follow/previous/
        timestamps apply server-side. Raises StreamError on failure."""

    async def close(self) -> None:
        """Release any transport resources."""
