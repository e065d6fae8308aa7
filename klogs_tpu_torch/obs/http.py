"""The /metrics, /healthz, /readyz, /traces and /profile HTTP sidecar.

Counterpart of ``klogs_tpu/obs/http.py``: a small asyncio HTTP/1.1
server. GET /metrics serves the Prometheus text exposition of one
Registry, /healthz (liveness: should this process be restarted?) and
/readyz (readiness: should traffic be routed here?) the Health state,
/traces the tracer's finished spans and /profile the profiler's last
snapshot, all as JSON.

A request the server cannot parse (a header line past the reader's
limit, a truncated request line) is dropped quietly: no response, no
unhandled-task traceback, and the server goes on serving. The drop is a
staged close: the server shuts its sending side, reads and discards
what the peer still sends (bounded in bytes and time), then closes.
Closing at once with unread bytes would make the kernel answer with a
reset, and the peer would lose even the orderly end of the connection.
"""

import asyncio
import json
from typing import TYPE_CHECKING, Callable

from klogs_tpu_torch.obs.expo import render

if TYPE_CHECKING:
    from klogs_tpu_torch.obs.metrics import Registry

_REQ_TIMEOUT_S = 5.0
# A dropped request's staged close discards at most this many bytes of
# what the peer still sends, for at most this long.
_LINGER_BYTES = 1 << 20
_LINGER_S = 2.0


class Health:
    """Named liveness and readiness checks and the warm flag.

    ``live_checks``/``ready_checks`` map name -> () -> bool; a check
    that raises counts as failed (a probe must never end the process).
    Readiness also needs ``set_ready()`` or ``mark_warm()``.
    """

    def __init__(self) -> None:
        self._ready = False
        self._drained = False
        self.live_checks: dict[str, Callable[[], bool]] = {}
        self.ready_checks: dict[str, Callable[[], bool]] = {}

    def add_live_check(self, name: str, fn: Callable[[], bool]) -> None:
        self.live_checks[name] = fn

    def add_ready_check(self, name: str, fn: Callable[[], bool]) -> None:
        self.ready_checks[name] = fn

    def set_ready(self, ready: bool = True) -> None:
        self._ready = ready
        self._drained = not ready

    def mark_warm(self) -> None:
        """Turn readiness on, unless a ``set_ready(False)`` drain came
        first (a warm-up finishing late must not undo a drain)."""
        if not self._drained:
            self._ready = True

    @staticmethod
    def _run(checks: dict[str, Callable[[], bool]]) -> tuple[bool, dict]:
        detail = {}
        ok = True
        for name, fn in checks.items():
            try:
                good = bool(fn())
            except Exception:
                good = False
            detail[name] = good
            ok = ok and good
        return ok, detail

    def liveness(self) -> tuple[bool, dict]:
        ok, detail = self._run(self.live_checks)
        return ok, {"live": ok, "ready": self._ready, "checks": detail}

    def readiness(self) -> tuple[bool, dict]:
        ok, detail = self._run(self.ready_checks)
        ok = ok and self._ready
        return ok, {"ready": ok, "warm": self._ready, "checks": detail}


async def _discard(reader: asyncio.StreamReader) -> None:
    """Read and drop up to ``_LINGER_BYTES`` or to the peer's EOF."""
    left = _LINGER_BYTES
    while left > 0:
        chunk = await reader.read(min(left, 1 << 16))
        if not chunk:
            return
        left -= len(chunk)


class MetricsHTTPServer:
    """Serves one Registry (and optionally a Health) over plain HTTP,
    bound to 127.0.0.1 unless ``host`` says otherwise. ``tracer`` and
    ``profiler`` default to the process-wide ones."""

    def __init__(self, registry: "Registry", health: "Health | None" = None,
                 host: str = "127.0.0.1", port: int = 0,
                 tracer=None, profiler=None) -> None:
        self.registry = registry
        self.health = health
        self.host = host
        self.port = port
        self.tracer = tracer
        self.profiler = profiler
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> int:
        """Bind and serve; returns the bound port (0 asks the OS)."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        consumed = False  # the whole request was read
        try:
            line = await asyncio.wait_for(reader.readline(), _REQ_TIMEOUT_S)
            parts = line.decode("latin-1", "replace").split()
            if len(parts) < 2:
                return
            target = parts[1].split("?", 1)
            method, path = parts[0], target[0]
            query = target[1] if len(target) > 1 else ""
            # Drain the headers (requests are small; no bodies).
            while True:
                h = await asyncio.wait_for(reader.readline(),
                                           _REQ_TIMEOUT_S)
                if h in (b"\r\n", b"\n", b""):
                    break
            consumed = True
            if method == "GET" and path == "/metrics":
                # The process gauges refresh per scrape; /proc reads are
                # file I/O, so off the loop.
                from klogs_tpu_torch.obs.profiler import (
                    refresh_process_metrics,
                )

                await asyncio.to_thread(refresh_process_metrics,
                                        self.registry)
            status, ctype, body = self._route(method, path, query)
            head = (f"HTTP/1.1 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n")
            writer.write(head.encode("latin-1") + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        except Exception:
            # A header line past the reader's limit raises ValueError;
            # an operator surface drops such a request rather than let
            # it surface as an unretrieved task exception.
            pass
        finally:
            try:
                if not consumed and writer.can_write_eof():
                    # The staged close (module docstring).
                    writer.write_eof()
                    await asyncio.wait_for(_discard(reader), _LINGER_S)
            except Exception:
                pass
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    def _route(self, method: str, path: str,
               query: str = "") -> tuple[str, str, bytes]:
        if method != "GET":
            return ("405 Method Not Allowed", "text/plain; charset=utf-8",
                    b"method not allowed\n")
        if path == "/metrics":
            # Exemplars only on request (?exemplars=1): the 0.0.4 text
            # parser rejects any suffix after a sample value.
            want_ex = "exemplars=1" in query
            body = render(self.registry, exemplars=want_ex).encode()
            return ("200 OK",
                    "text/plain; version=0.0.4; charset=utf-8", body)
        if path == "/traces":
            from klogs_tpu_torch.obs import trace as _trace

            tracer = self.tracer if self.tracer is not None else _trace.TRACER
            body = (json.dumps(tracer.traces_doc()) + "\n").encode()
            return ("200 OK", "application/json", body)
        if path == "/profile":
            from klogs_tpu_torch.obs import profiler as _profiler

            prof = (self.profiler if self.profiler is not None
                    else _profiler.PROFILER)
            body = (json.dumps(prof.profile_doc()) + "\n").encode()
            return ("200 OK", "application/json", body)
        if path in ("/healthz", "/readyz"):
            if self.health is None:
                return ("200 OK", "application/json",
                        b'{"live": true}\n')
            ok, doc = (self.health.liveness() if path == "/healthz"
                       else self.health.readiness())
            body = (json.dumps(doc) + "\n").encode()
            return ("200 OK" if ok else "503 Service Unavailable",
                    "application/json", body)
        return ("404 Not Found", "text/plain; charset=utf-8",
                b"try /metrics, /healthz, /readyz, /traces, or "
                b"/profile\n")
