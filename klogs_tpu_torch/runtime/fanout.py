"""Concurrent per-container log acquisition (the non-follow path).

Counterpart of ``klogs_tpu/runtime/fanout.py``: one worker per (pod,
container), every log file created (truncated) before any worker
starts, a bound on concurrent stream opens (the reference's apiserver
burst of 100), and per-stream error isolation (one bad container never
ends the run). Follow mode, reconnects and discovery are not part of
this port yet.
"""

import asyncio
import os
import re
from dataclasses import dataclass
from typing import Callable

from klogs_tpu_torch.cluster.backend import ClusterBackend, StreamError
from klogs_tpu_torch.cluster.types import LogOptions, PodInfo
from klogs_tpu_torch.runtime.sink import FileSink, Sink, SinkError
from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.naming import log_file_name

DEFAULT_OPEN_BURST = 100


@dataclass
class StreamJob:
    pod: str
    container: str
    init: bool
    path: str


@dataclass
class StreamResult:
    job: StreamJob
    bytes_written: int = 0
    error: str | None = None


SinkFactory = Callable[[StreamJob], Sink]


def plan_jobs(
    pods: list[PodInfo], log_path: str, include_init: bool,
    container_re: "re.Pattern | None" = None,
    exclude_container_re: "re.Pattern | None" = None,
) -> list[StreamJob]:
    """Jobs in the reference's file-creation order: per pod, init
    containers first (with -i), then regular ones. A (pod, container)
    pair selected twice (several -l selectors) streams once.
    ``container_re``/``exclude_container_re`` (-c/-E) keep containers
    whose name re.search-matches the include and not the exclude."""
    jobs = []
    seen: set[tuple[str, str, bool]] = set()

    def want(name: str) -> bool:
        if container_re is not None and not container_re.search(name):
            return False
        return (exclude_container_re is None
                or not exclude_container_re.search(name))

    for pod in pods:
        groups = ([(c, True) for c in pod.init_containers] if include_init
                  else []) + [(c, False) for c in pod.containers]
        for c, init in groups:
            key = (pod.name, c.name, init)
            if key not in seen and want(c.name):
                seen.add(key)
                jobs.append(StreamJob(pod.name, c.name, init, os.path.join(
                    log_path, log_file_name(pod.name, c.name))))
    return jobs


class FanoutRunner:
    def __init__(self, backend: ClusterBackend, namespace: str,
                 log_opts: LogOptions,
                 sink_factory: SinkFactory | None = None,
                 open_burst: int = DEFAULT_OPEN_BURST):
        self.backend = backend
        self.namespace = namespace
        self.log_opts = log_opts
        self.sink_factory = sink_factory or (lambda job: FileSink(job.path))
        self._open_burst = open_burst
        # Created inside run(), on the running loop.
        self._open_sem: "asyncio.Semaphore | None" = None

    async def _worker(self, job: StreamJob) -> StreamResult:
        result = StreamResult(job=job)
        opts = LogOptions(since_seconds=self.log_opts.since_seconds,
                          tail_lines=self.log_opts.tail_lines,
                          container=job.container)
        sink = self.sink_factory(job)
        try:
            try:
                async with self._open_sem:
                    stream = await self.backend.open_log_stream(
                        self.namespace, job.pod, opts)
            except StreamError as e:
                term.error("Error getting logs for container %s\n%s",
                           job.container, e)
                result.error = str(e)
                return result
            try:
                async for chunk in stream:
                    await sink.write(chunk)
            except StreamError as e:
                term.error("Error reading logs for container %s\n%s",
                           job.container, e)
                result.error = str(e)
            except SinkError as e:
                term.error("Sink failed for container %s\n%s",
                           job.container, e)
                result.error = str(e)
            finally:
                await stream.close()
            return result
        finally:
            try:
                await sink.close()
            except SinkError as e:
                if result.error is None:
                    term.error("Sink close failed for container %s\n%s",
                               job.container, e)
                    result.error = str(e)
            result.bytes_written = sink.bytes_written

    @staticmethod
    def _create_files(jobs: list[StreamJob]) -> None:
        for job in jobs:
            os.makedirs(os.path.dirname(job.path) or ".", exist_ok=True)
            open(job.path, "wb").close()

    async def run(self, jobs: list[StreamJob]) -> list[StreamResult]:
        """Create every log file, then run all workers to completion."""
        # Off the loop: truncating hundreds of files is disk I/O.
        await asyncio.to_thread(self._create_files, jobs)
        self._open_sem = asyncio.Semaphore(self._open_burst)
        tasks = [asyncio.create_task(self._worker(j)) for j in jobs]
        try:
            return await asyncio.gather(*tasks)
        except BaseException:
            # A worker raised (or run() was cancelled): let the others
            # finish closing their sinks before the error surfaces.
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
