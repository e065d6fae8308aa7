"""Backfill of rotated, compressed log archives ("grep a week of
archived logs for 1k patterns").

Counterpart of ``klogs_tpu/sources/archive.py``. Each logical stream
is decompressed by one daemon thread into a bounded queue of
newline-aligned slabs (~1 MiB) that the event loop takes: no per-line
Python on the way. zlib releases the GIL while it inflates, so the
threads overlap with the engine; the queue's bound
(KLOGS_SOURCE_READAHEAD_MB) is the backpressure: a slow engine blocks
the producer's ``put`` and memory does not grow. The threads touch no
torch and no CUDA state: every device call stays on the loop's thread.

A rotated set is one logical stream in time order: for ``app.log`` the
members ``app.log.3.gz … app.log.1.gz, app.log`` are read oldest
first, so a backfill writes what a live follow of the file would have.

Errors: a gzip or zstd member that ends mid-stream raises
``SourceError`` naming the archive and the compressed byte offset where
decoding stopped, and corrupt bytes raise the same with the codec's
detail. zstd needs the ``zstandard`` package and is refused with
``SourceConfigError`` without it.

Each slab's inflate and newline cut, in the producer thread, is a
``source.read`` span (the wait in ``put``, where the engine's
backpressure parks the thread, is outside it: waiting for the consumer
is not the source's cost). ``source.readahead_slabs``, a profiler probe,
is the slabs queued over every live set; ``source.open`` and
``source.read`` are fault points.
"""

from __future__ import annotations

import asyncio
import queue
import re
import threading
import zlib
from typing import Iterator, Union

from klogs_tpu_torch.cluster.types import LogOptions
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.obs.profiler import PROFILER
from klogs_tpu_torch.sources.base import (
    Source,
    SourceConfigError,
    SourceError,
    SourceMetrics,
    SourceRef,
    SourceStream,
    fire_fault,
    safe_group_name,
)
from klogs_tpu_torch.sources.replay import _expand_paths

DEFAULT_SLAB_BYTES = 1 << 20
_COMPRESS_EXTS = (".gz", ".zst", ".zstd")
_ROTATE_N = re.compile(r"^(?P<base>.+)\.(?P<n>\d+)$")
# Queue items: a slab, the terminal error, or the end-of-stream None.
_Item = Union[bytes, SourceError, None]


def strip_compress_ext(path: str) -> "tuple[str, str]":
    """('app.log.2', 'gz') from 'app.log.2.gz'; codec '' = plain."""
    for ext in _COMPRESS_EXTS:
        if path.endswith(ext):
            return path[: -len(ext)], ext.lstrip(".")
    return path, ""


def group_archives(files: "list[str]") -> "dict[str, list[str]]":
    """Rotated members under their base name, oldest first: numeric
    suffixes descending, the bare (live) file last.
    ``{'d/app.log': ['d/app.log.2.gz', 'd/app.log.1.gz', 'd/app.log']}``."""
    groups: "dict[str, list[tuple[int, str]]]" = {}
    for path in files:
        logical, _codec = strip_compress_ext(path)
        m = _ROTATE_N.match(logical)
        if m:
            groups.setdefault(m.group("base"), []).append(
                (int(m.group("n")), path))
        else:
            # -1, the live file, sorts after every numbered member.
            groups.setdefault(logical, []).append((-1, path))
    return {
        base: [p for _n, p in sorted(members, key=lambda t: -t[0])]
        for base, members in sorted(groups.items())
    }


class ArchiveStream(SourceStream):
    """One logical (rotated) set, decompressed by a producer thread into
    a bounded slab queue. The thread talks to the loop only through the
    queue and the thread-safe wake-up."""

    def __init__(self, ref: SourceRef, members: "list[str]", *,
                 metrics: "SourceMetrics | None" = None,
                 readahead_slabs: int = 8,
                 slab_bytes: int = DEFAULT_SLAB_BYTES) -> None:
        self._ref = ref
        self._members = list(members)
        self._metrics = metrics if metrics is not None else SourceMetrics(
            ref.kind)
        self._readahead = max(1, readahead_slabs)
        self._slab = slab_bytes
        self._q: "queue.Queue[_Item] | None" = None
        self._thread: "threading.Thread | None" = None
        self._wake: "asyncio.Event | None" = None
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._done = False
        self._closed = False

    # -- producer thread -----------------------------------------------

    def _put(self, item: _Item) -> bool:
        assert self._q is not None
        while True:
            try:
                # The timeout only re-checks _closed; space the consumer
                # frees wakes the put at once.
                self._q.put(item, timeout=0.2)
            except queue.Full:
                if self._closed:
                    return False
                continue
            self._notify()
            return True

    def _notify(self) -> None:
        loop, wake = self._loop, self._wake
        if loop is None or wake is None:
            return
        try:
            loop.call_soon_threadsafe(wake.set)
        except RuntimeError:
            pass  # the loop is already closed (teardown)

    def _produce(self) -> None:
        tail = b""  # the carried partial last line
        try:
            for path in self._members:
                if self._closed:
                    return
                it = self._decompress(path)
                while True:
                    # Checked every slab: after close() drains the queue
                    # it never fills, and the thread must still stop.
                    if self._closed:
                        return
                    slab = None
                    # The span covers the source's own work, the inflate
                    # and the cut; the put stays outside it.
                    with trace.TRACER.span("source.read", kind="archive",
                                           group=self._ref.group):
                        chunk = next(it, None)
                        if chunk is not None:
                            # Each decompressed chunk becomes one slab,
                            # cut at its last newline with the rest
                            # carried: one copy a byte, since every copy
                            # here holds the GIL.
                            cut = chunk.rfind(b"\n")
                            if cut < 0:
                                tail += chunk
                                if len(tail) >= 4 * self._slab:
                                    # No newline at all: emit the bytes
                                    # as they are rather than grow.
                                    slab, tail = tail, b""
                            else:
                                mv = memoryview(chunk)
                                slab = (b"".join((tail, mv[:cut + 1]))
                                        if tail else chunk[:cut + 1])
                                tail = bytes(mv[cut + 1:])
                    if slab is not None and not self._put(slab):
                        return
                    if chunk is None:
                        break
                self._metrics.member()
            if tail:
                self._put(tail)
            self._put(None)
        except SourceError as exc:
            self._metrics.error()
            self._put(exc)
        except Exception as exc:  # noqa: BLE001 — ends the stream as a SourceError
            self._metrics.error()
            self._put(SourceError(f"archive read failed: {exc}"))

    def _decompress(self, path: str) -> Iterator[bytes]:
        if path.endswith(".gz"):
            yield from self._gunzip(path)
        elif path.endswith((".zst", ".zstd")):
            yield from self._unzstd(path)
        else:
            with open(path, "rb") as f:
                while chunk := f.read(self._slab):
                    yield chunk

    def _gunzip(self, path: str) -> Iterator[bytes]:
        """Streaming multi-member gunzip; a member cut short or corrupt
        bytes raise SourceError with the compressed byte offset."""
        with open(path, "rb") as f:
            d = zlib.decompressobj(31)  # 31: the gzip wrapper
            consumed = 0  # compressed bytes of the members decoded whole
            mid_member = False
            while True:
                # ~half a slab of compressed bytes a step: at log
                # ratios one step inflates to about one slab.
                raw = f.read(max(1 << 18, self._slab >> 1))
                if not raw:
                    if mid_member:
                        raise SourceError(
                            f"truncated gzip member in {path} at "
                            f"compressed byte {consumed}",
                            path=path, offset=consumed)
                    return
                data = raw
                while data:
                    try:
                        out = d.decompress(data)
                    except zlib.error as exc:
                        raise SourceError(
                            f"corrupt gzip data in {path} near "
                            f"compressed byte {consumed}: {exc}",
                            path=path, offset=consumed) from exc
                    if out:
                        yield out
                    if d.eof:
                        leftover = d.unused_data
                        consumed += len(data) - len(leftover)
                        d = zlib.decompressobj(31)
                        mid_member = False
                        data = leftover
                    else:
                        consumed += len(data)
                        mid_member = True
                        data = b""

    def _unzstd(self, path: str) -> Iterator[bytes]:
        """Streaming multi-frame zstd, frame by frame as ``_gunzip``
        goes member by member: a frame cut short or corrupt bytes raise
        SourceError with the compressed byte offset."""
        try:
            import zstandard
        except ImportError:
            raise SourceConfigError(
                f"cannot read {path}: zstd support requires the "
                "'zstandard' package", path=path) from None
        dctx = zstandard.ZstdDecompressor()
        with open(path, "rb") as f:
            d = dctx.decompressobj()
            consumed = 0  # compressed bytes of the frames decoded whole
            mid_frame = False
            while True:
                raw = f.read(max(1 << 18, self._slab >> 1))
                if not raw:
                    if mid_frame:
                        raise SourceError(
                            f"truncated zstd frame in {path} at "
                            f"compressed byte {consumed}",
                            path=path, offset=consumed)
                    return
                data = raw
                while data:
                    try:
                        out = d.decompress(data)
                    except zstandard.ZstdError as exc:
                        raise SourceError(
                            f"corrupt zstd data in {path} near "
                            f"compressed byte {consumed}: {exc}",
                            path=path, offset=consumed) from exc
                    if out:
                        yield out
                    if d.eof:
                        leftover = d.unused_data
                        consumed += len(data) - len(leftover)
                        d = dctx.decompressobj()
                        mid_frame = False
                        data = leftover
                    else:
                        consumed += len(data)
                        mid_frame = True
                        data = b""

    # -- consumer (the event loop) -------------------------------------

    def _ensure_started(self) -> None:
        if self._thread is not None:
            return
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._q = queue.Queue(maxsize=self._readahead)
        self._thread = threading.Thread(
            target=self._produce, daemon=True,
            name=f"klogs-archive-{self._ref.group}")
        self._thread.start()

    def readahead_depth(self) -> int:
        q = self._q
        return q.qsize() if q is not None else 0

    def __aiter__(self) -> "ArchiveStream":
        return self

    async def __anext__(self) -> bytes:
        self._ensure_started()
        assert self._q is not None and self._wake is not None
        if self._closed or self._done:
            raise StopAsyncIteration
        await fire_fault("source.read", self._metrics, self._ref.group,
                         self._members[0] if self._members else "")
        # No span here: the producer's inflate carries source.read;
        # waiting on the queue is the engine's backpressure or loop lag.
        while True:
            try:
                item = self._q.get_nowait()
                break
            except queue.Empty:
                pass
            self._wake.clear()
            # Again after the clear: a put between the first try and the
            # clear would otherwise be missed until the next one.
            try:
                item = self._q.get_nowait()
                break
            except queue.Empty:
                pass
            if self._closed:
                raise StopAsyncIteration
            await self._wake.wait()
        if item is None:
            self._done = True
            raise StopAsyncIteration
        if isinstance(item, SourceError):
            self._done = True
            raise item
        self._metrics.add_bytes(len(item))
        return item

    async def close(self) -> None:
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        q = self._q
        if q is not None:
            # Drained, so a producer blocked in put() sees _closed.
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        t = self._thread
        if t is not None and t.is_alive():
            # Off the loop: the producer stops at its next _closed check
            # (the next slab, or a blocked put's 0.2 s timeout).
            await asyncio.to_thread(t.join, 2.0)


class ArchiveSource(Source):
    kind = "archive"

    def __init__(self, paths: "list[str]", *, readahead_mb: int = 8,
                 slab_bytes: int = DEFAULT_SLAB_BYTES) -> None:
        super().__init__()
        self.paths = list(paths)
        self.slab_bytes = slab_bytes
        self.readahead_slabs = max(
            1, (readahead_mb << 20) // max(1, slab_bytes))
        self._members: "dict[str, list[str]]" = {}
        self._live: "set[ArchiveStream]" = set()
        self._probe_added = False

    async def start(self) -> None:
        if not self._probe_added:
            PROFILER.add_probe("source.readahead_slabs",
                               self._readahead_probe)
            self._probe_added = True

    def _readahead_probe(self) -> float:
        return float(sum(s.readahead_depth() for s in self._live))

    async def discover(self) -> "list[SourceRef]":
        files = await asyncio.to_thread(_expand_paths, self.paths)
        if not files:
            raise SourceError(
                "backfill: no archive files found under "
                + ", ".join(self.paths))
        refs: "list[SourceRef]" = []
        groups: "set[str]" = set()
        for base, members in group_archives(files).items():
            group = safe_group_name(base)
            if group in groups:
                group = f"{group}-{len(groups)}"
            groups.add(group)
            self._members[group] = members
            refs.append(SourceRef(kind=self.kind, group=group,
                                  unit="archive", target=base))
        return refs

    async def open_stream(self, ref: SourceRef,
                          opts: LogOptions) -> SourceStream:
        await fire_fault("source.open", self.metrics, ref.group, ref.target)
        members = self._members.get(ref.group)
        if not members:
            self.metrics.error()
            raise SourceError(f"unknown archive set: {ref.group}",
                              path=ref.target)
        stream = ArchiveStream(ref, members, metrics=self.metrics,
                               readahead_slabs=self.readahead_slabs,
                               slab_bytes=self.slab_bytes)
        self._live.add(stream)
        return stream

    async def close(self) -> None:
        if self._probe_added:
            PROFILER.remove_probe("source.readahead_slabs",
                                  self._readahead_probe)
            self._probe_added = False
        for stream in list(self._live):
            await stream.close()
        self._live.clear()
