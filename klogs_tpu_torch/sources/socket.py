"""A newline-delimited TCP or Unix-socket listener whose connections
become fan-out streams.

Counterpart of ``klogs_tpu/sources/socket.py``. Backpressure reaches
the peer by construction, not by buffering: a connection is read only
inside its stream's ``__anext__``, so when the sink stalls the
StreamReader's 64 KiB limit pauses the transport, the kernel's receive
window fills and the peer's ``send`` blocks. No queue on the path is
unbounded.

Connections are ``ephemeral`` refs: a peer hanging up ends its stream
without a reconnect or a "premature end" warning. New connections join
through follow mode's discovery polling, so the mode needs ``-f``. The
accept cap (KLOGS_SOCKET_MAX_CONNS) bounds the open connections.

Each read is a ``source.read`` span; ``source.open`` and
``source.read`` are fault points.

``close()`` closes the accepted connections before it waits for the
server: since Python 3.12 ``Server.wait_closed()`` waits for every
accepted connection, so waiting first would never return while a peer
is still connected.
"""

from __future__ import annotations

import asyncio
import os
import stat as stat_mod

from klogs_tpu_torch.cluster.types import LogOptions
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.sources.base import (
    Source,
    SourceError,
    SourceMetrics,
    SourceRef,
    SourceStream,
    fire_fault,
)

READ_SIZE = 1 << 16
FLOW_LIMIT = 1 << 16  # the StreamReader's high-water mark: one read


class SocketStream(SourceStream):
    def __init__(self, ref: SourceRef, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *,
                 source: "SocketSource",
                 metrics: "SourceMetrics | None" = None) -> None:
        self._ref = ref
        self._metrics = metrics if metrics is not None else SourceMetrics(
            ref.kind)
        self._reader = reader
        self._writer = writer
        self._source = source
        self._closed = False

    def __aiter__(self) -> "SocketStream":
        return self

    async def __anext__(self) -> bytes:
        if self._closed:
            raise StopAsyncIteration
        await fire_fault("source.read", self._metrics, self._ref.group,
                         self._ref.target)
        with trace.TRACER.span("source.read", kind="socket",
                               group=self._ref.group):
            try:
                data = await self._reader.read(READ_SIZE)
            except (ConnectionError, OSError) as exc:
                self._metrics.error()
                await self.close()
                raise SourceError(
                    f"socket peer {self._ref.group}: {exc}") from exc
        if not data:
            await self.close()
            raise StopAsyncIteration
        self._metrics.add_bytes(len(data))
        return data

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._source._release(self._ref.target)
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass


class SocketSource(Source):
    """``start()`` binds (on the loop, never in the constructor), the
    accept callback only registers the connection, and ``discover()``
    lists the registered peers as ephemeral refs."""

    kind = "socket"

    def __init__(self, target: str, *, max_conns: int = 64) -> None:
        super().__init__()
        self.target = target
        self.max_conns = max_conns
        self._server: "asyncio.Server | None" = None
        self._unix_path: "str | None" = None
        # conn id -> (reader, writer); changed only on the loop.
        self._conns: "dict[str, tuple[asyncio.StreamReader, asyncio.StreamWriter]]" = {}
        self._next_id = 0

    async def start(self) -> None:
        if self._server is not None:
            return
        try:
            if self.target.startswith("unix:"):
                path = self.target[len("unix:"):]
                await asyncio.to_thread(self._unlink_stale, path)
                self._server = await asyncio.start_unix_server(
                    self._on_conn, path=path, limit=FLOW_LIMIT)
                self._unix_path = path
            else:
                host, _, port = self.target.rpartition(":")
                if not host or not port.isdigit():
                    raise SourceError(
                        f"bad socket listen spec {self.target!r}: "
                        "expected HOST:PORT or unix:/path.sock")
                self._server = await asyncio.start_server(
                    self._on_conn, host=host, port=int(port),
                    limit=FLOW_LIMIT)
        except OSError as exc:
            self.metrics.error()
            raise SourceError(
                f"cannot listen on {self.target}: {exc}") from exc

    @staticmethod
    def _unlink_stale(path: str) -> None:
        try:
            if stat_mod.S_ISSOCK(os.stat(path).st_mode):
                os.unlink(path)
        except FileNotFoundError:
            pass

    def bound_port(self) -> int:
        """The port the kernel chose (for a listen spec with port 0)."""
        assert self._server is not None and self._server.sockets
        addr = self._server.sockets[0].getsockname()
        return int(addr[1]) if isinstance(addr, tuple) else 0

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        if len(self._conns) >= self.max_conns:
            writer.close()
            return
        name = f"conn-{self._next_id:04d}"
        self._next_id += 1
        self._conns[name] = (reader, writer)
        self.metrics.connection()

    def _release(self, name: str) -> None:
        self._conns.pop(name, None)

    async def discover(self) -> "list[SourceRef]":
        await self.start()
        return [
            SourceRef(kind=self.kind, group=name, unit="peer",
                      target=name, ephemeral=True)
            for name in self._conns
        ]

    async def open_stream(self, ref: SourceRef,
                          opts: LogOptions) -> SourceStream:
        await fire_fault("source.open", self.metrics, ref.group, ref.target)
        pair = self._conns.get(ref.target)
        if pair is None:
            self.metrics.error()
            raise SourceError(f"connection {ref.target} is gone")
        return SocketStream(ref, pair[0], pair[1], source=self,
                            metrics=self.metrics)

    async def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.close()  # no new connections
        # The peers' connections first: wait_closed() waits for them.
        for _reader, writer in list(self._conns.values()):
            writer.close()
        self._conns.clear()
        if server is not None:
            await server.wait_closed()
        if self._unix_path is not None:
            await asyncio.to_thread(self._unlink_stale, self._unix_path)
            self._unix_path = None
