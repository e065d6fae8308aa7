"""File and directory replay source.

Counterpart of ``klogs_tpu/sources/replay.py``. Streams local files
through the same per-stream fan-out workers as the kube path, and
follows logrotate's lifecycle:

* **rotation by rename**: EOF and a new inode at the path mean the file
  was rotated away; the old fd is drained first (bytes written between
  the last read and the rename are kept), then the new file is read
  from offset 0.
* **truncation in place** (``copytruncate``): a size below the read
  position re-reads from 0.
* **resume offsets**: per (path, inode) the source remembers the last
  line-aligned byte delivered, and a re-open of the same file resumes
  there, so it re-emits at most the one partial line in flight.
* **glob re-discovery**: ``discover()`` expands directories and globs
  again, so in follow mode new files join the fan-out.

Chunks are 256 KiB reads cut at the last newline with the tail carried.
``--replay-rate`` / KLOGS_REPLAY_RATE paces a stream at N lines/s. Each
read is a ``source.read`` span; ``source.open`` and ``source.read`` are
fault points, fired as SourceError.
"""

from __future__ import annotations

import asyncio
import glob
import os
import time
import zlib
from typing import BinaryIO

from klogs_tpu_torch.cluster.types import LogOptions
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.sources.base import (
    Source,
    SourceError,
    SourceMetrics,
    SourceRef,
    SourceStream,
    fire_fault,
    safe_group_name,
)

DEFAULT_READ_SIZE = 256 << 10
DEFAULT_POLL_S = 0.2
_GLOB_CHARS = frozenset("*?[")


def _expand_paths(specs: "list[str]") -> "list[str]":
    """Files, directories (their direct regular files, dot files
    skipped) and glob patterns, as one ordered list without repeats."""
    out: "list[str]" = []
    for spec in specs:
        if _GLOB_CHARS & set(spec):
            out.extend(sorted(p for p in glob.glob(spec)
                              if os.path.isfile(p)))
        elif os.path.isdir(spec):
            for name in sorted(os.listdir(spec)):
                p = os.path.join(spec, name)
                if os.path.isfile(p) and not name.startswith("."):
                    out.append(p)
        elif os.path.isfile(spec):
            out.append(spec)
    return list(dict.fromkeys(out))


class ReplayStream(SourceStream):
    """One file's stream. Blocking I/O runs in ``asyncio.to_thread``;
    the loop only sees newline-aligned slabs."""

    def __init__(self, ref: SourceRef, follow: bool, *,
                 offsets: "dict[str, tuple[int, int]]",
                 metrics: "SourceMetrics | None" = None,
                 rate_lps: "float | None" = None,
                 poll_s: float = DEFAULT_POLL_S,
                 read_size: int = DEFAULT_READ_SIZE) -> None:
        self._ref = ref
        self._path = ref.target
        self._follow = follow
        self._offsets = offsets
        self._metrics = metrics if metrics is not None else SourceMetrics(
            ref.kind)
        self._rate = rate_lps
        self._poll_s = poll_s
        self._read_size = read_size
        self._f: "BinaryIO | None" = None
        self._inode = -1
        self._pos = 0
        self._tail = b""
        self._closed = False
        self._wake: "asyncio.Event | None" = None  # made on the loop
        self._t0: "float | None" = None
        self._due = 0.0

    def _wake_ev(self) -> asyncio.Event:
        if self._wake is None:
            self._wake = asyncio.Event()
        return self._wake

    # -- blocking half (a worker thread) -------------------------------

    def _open_file(self) -> None:
        f = open(self._path, "rb")
        try:
            st = os.fstat(f.fileno())
            pos = 0
            prev = self._offsets.get(self._path)
            if prev is not None and prev[0] == st.st_ino \
                    and prev[1] <= st.st_size:
                pos = prev[1]
            f.seek(pos)
        except BaseException:
            f.close()  # no fd leaks when fstat or seek fails
            raise
        self._f, self._inode, self._pos = f, st.st_ino, pos

    def _step(self) -> "tuple[str, bytes]":
        """One poll: ('data', raw) | ('rotate', old_fd_remainder) |
        ('eof', b'') | ('wait', b'')."""
        if self._f is None:
            try:
                self._open_file()
            except FileNotFoundError:
                return ("wait", b"") if self._follow else ("eof", b"")
        assert self._f is not None
        data = self._f.read(self._read_size)
        if data:
            self._pos += len(data)
            return ("data", data)
        if not self._follow:
            return ("eof", b"")
        try:
            st = os.stat(self._path)
        except FileNotFoundError:
            # Renamed away with no successor yet: the old fd is drained;
            # watch the path for a new file.
            self._close_file(forget=True)
            return ("wait", b"")
        if st.st_ino != self._inode:
            rest = self._f.read()
            self._close_file(forget=True)
            return ("rotate", rest)
        if st.st_size < self._pos:
            self._f.seek(0)
            self._pos = 0
            return ("rotate", b"")
        return ("wait", b"")

    def _close_file(self, forget: bool = False) -> None:
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None
        if forget:
            self._offsets.pop(self._path, None)
            self._inode = -1
            self._pos = 0

    # -- async half ----------------------------------------------------

    def __aiter__(self) -> "ReplayStream":
        return self

    async def __anext__(self) -> bytes:
        while True:
            if self._closed:
                raise StopAsyncIteration
            await fire_fault("source.read", self._metrics, self._ref.group,
                             self._path)
            with trace.TRACER.span("source.read", kind="file",
                                   group=self._ref.group):
                kind, data = await asyncio.to_thread(self._step)
            if kind == "data":
                buf = self._tail + data
                cut = buf.rfind(b"\n")
                if cut < 0:
                    self._tail = buf
                    continue
                out, self._tail = buf[:cut + 1], buf[cut + 1:]
                # The resume point: everything before the carried tail
                # went out line-aligned.
                self._offsets[self._path] = (
                    self._inode, self._pos - len(self._tail))
                self._metrics.add_bytes(len(out))
                await self._pace(out)
                return out
            if kind == "rotate":
                self._metrics.rotation()
                out, self._tail = self._tail + data, b""
                if out:
                    self._metrics.add_bytes(len(out))
                    return out
                continue
            if kind == "eof":
                out, self._tail = self._tail, b""
                if out:
                    self._metrics.add_bytes(len(out))
                    return out
                raise StopAsyncIteration
            try:  # wait
                await asyncio.wait_for(self._wake_ev().wait(),
                                       self._poll_s)
            except asyncio.TimeoutError:
                pass

    async def _pace(self, out: bytes) -> None:
        if self._rate is None:
            return
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        self._due += out.count(b"\n") / self._rate
        delay = self._due - (now - self._t0)
        if delay > 0:
            await asyncio.sleep(delay)

    async def close(self) -> None:
        self._closed = True
        self._wake_ev().set()
        await asyncio.to_thread(self._close_file)


class ReplaySource(Source):
    kind = "file"

    def __init__(self, paths: "list[str]", *,
                 rate_lps: "float | None" = None,
                 poll_interval_s: float = DEFAULT_POLL_S,
                 read_size: int = DEFAULT_READ_SIZE) -> None:
        super().__init__()
        self.paths = list(paths)
        self.rate_lps = rate_lps
        self.poll_interval_s = poll_interval_s
        self.read_size = read_size
        # path -> (inode, line-aligned offset), read on a re-open.
        self._offsets: "dict[str, tuple[int, int]]" = {}

    async def discover(self) -> "list[SourceRef]":
        files = await asyncio.to_thread(_expand_paths, self.paths)
        refs: "list[SourceRef]" = []
        groups: "set[str]" = set()
        for path in files:
            group = safe_group_name(path)
            if group in groups:
                # Distinct paths that sanitize alike stay distinct, by a
                # suffix derived from the path itself.
                group = f"{group}-{zlib.crc32(path.encode()) & 0xffff:04x}"
            groups.add(group)
            refs.append(SourceRef(kind=self.kind, group=group,
                                  unit="log", target=path))
        return refs

    async def open_stream(self, ref: SourceRef,
                          opts: LogOptions) -> SourceStream:
        await fire_fault("source.open", self.metrics, ref.group, ref.target)
        if not opts.follow \
                and not await asyncio.to_thread(os.path.isfile, ref.target):
            self.metrics.error()
            raise SourceError(f"no such file: {ref.target}",
                              path=ref.target)
        return ReplayStream(ref, opts.follow, offsets=self._offsets,
                            metrics=self.metrics, rate_lps=self.rate_lps,
                            poll_s=self.poll_interval_s,
                            read_size=self.read_size)
