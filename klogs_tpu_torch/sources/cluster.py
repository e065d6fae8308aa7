"""ClusterSource: a ClusterBackend seen through the Source contract.

Counterpart of ``klogs_tpu/sources/cluster.py``. The fan-out wraps it
around any backend when no ``--source`` is given. It adds nothing:
discovery is ``list_pods`` flattened to (pod, container) refs, and
``open_stream`` is ``open_log_stream`` as it is, so the kube and fake
paths stay byte-identical.
"""

from __future__ import annotations

from klogs_tpu_torch.cluster.backend import ClusterBackend
from klogs_tpu_torch.cluster.types import LogOptions
from klogs_tpu_torch.sources.base import Source, SourceRef, SourceStream


class ClusterSource(Source):
    kind = "pod"

    def __init__(self, backend: ClusterBackend, namespace: str) -> None:
        super().__init__()
        self.backend = backend
        self.namespace = namespace

    async def discover(self) -> "list[SourceRef]":
        return [SourceRef(kind=self.kind, group=pod.name, unit=c.name,
                          target=pod.name)
                for pod in await self.backend.list_pods(self.namespace)
                for c in pod.containers]

    async def open_stream(self, ref: SourceRef,
                          opts: LogOptions) -> SourceStream:
        # opts.container carries the unit, as the fan-out worker sets it;
        # the backend fires the kube.* fault points, no source.* here.
        return await self.backend.open_log_stream(
            self.namespace, ref.group, opts)

    async def close(self) -> None:
        await self.backend.close()
