"""ClusterBackend: the seam between the CLI and any cluster.

Counterpart of ``klogs_tpu/cluster/backend.py``. Everything above it
(pod selection, fan-out, filtering, sinks) talks to this interface, so
the hermetic FakeCluster serves every test and demo run. All methods are
async: the fan-out runs on one asyncio event loop.
"""

import abc
from typing import AsyncIterator

from klogs_tpu_torch.cluster.types import LogOptions, PodInfo


class ClusterError(Exception):
    """A cluster-access failure (apiserver error analog)."""


class StreamError(ClusterError):
    """Opening or reading a log stream failed."""


class LogStream(abc.ABC):
    """One container's log stream: an async iterator of byte chunks whose
    boundaries need not align with lines."""

    @abc.abstractmethod
    def __aiter__(self) -> AsyncIterator[bytes]: ...

    @abc.abstractmethod
    async def close(self) -> None: ...


class ClusterBackend(abc.ABC):
    @abc.abstractmethod
    def current_context(self) -> tuple[str, str]:
        """(context_name, default_namespace)."""

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
        """``opts.container`` must be set; since/tail apply server-side.
        Raises StreamError on failure."""

    async def close(self) -> None:
        """Release any transport resources."""
