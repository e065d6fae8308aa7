"""filterd: the process that owns the card and serves Match RPCs.

Counterpart of ``klogs_tpu/service/server.py``, single-set: one pattern
set (``--match``/``--exclude``/``-I``) on one GpuEngineFilter. Run it
with ``python -m klogs_tpu_torch.service --backend cuda --match ERROR
--port 50051``. Every client's batches go through one
AsyncFilterService, so concurrent collectors coalesce into shared
device batches however small each one's flushes are.

The CUDA libraries are built (nvcc, at first use) and loaded in a
worker thread before the port binds: the engine dispatches on the
event loop, and a build there would hold every Hello past its client's
deadline. A failed build raises out of ``start``. With a metrics port,
``/readyz`` answers 200 once a warmup batch has gone through the
coalescer and the card.

Transport security for a hop across nodes:

- TLS: ``tls_cert``/``tls_key``; ``tls_client_ca`` adds and checks
  client certificates (mTLS).
- Bearer auth: ``auth_token`` (or ``auth_token_file``, read again for
  each RPC so a rotated Secret works without a restart) rejects an RPC
  without ``authorization: Bearer <token>`` as UNAUTHENTICATED. Over
  plaintext the token travels in the clear; the banner says so.

Both are off by default. Partial TLS configuration is a constructor
error, never a plaintext fallback. The multi-set registry
(``--multi-set``, the Register RPC) is not ported yet: a Register RPC
answers UNIMPLEMENTED, which no client sends to a server whose Hello
lacks ``multi_set``.
"""

import asyncio
import hmac
import time

import grpc

from klogs_tpu_torch.filters.async_service import AsyncFilterService
from klogs_tpu_torch.filters.base import IncludeExcludeFilter
from klogs_tpu_torch.obs.profiler import PROFILER, FleetCapacity
from klogs_tpu_torch.service import transport
from klogs_tpu_torch.service.client import MAX_MESSAGE_BYTES
from klogs_tpu_torch.version import BUILD_VERSION


def _make_filter(patterns: list[str], ignore_case: bool = False,
                 exclude: "list[str] | None" = None, stats=None,
                 device=None):
    """The include/exclude engine on ``device``; the stats ride the
    first side built only (feeding both would count twice)."""
    from klogs_tpu_torch.filters.base import build_include_exclude
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter

    made = []

    def one(pats):
        f = GpuEngineFilter(pats, ignore_case=ignore_case, device=device,
                            stats=stats if not made else None)
        made.append(f)
        return f

    return build_include_exclude(one, patterns, exclude)


def _uses_device_sweep(filt) -> bool:
    """Whether an engine behind ``filt`` (perhaps an include/exclude
    pair) gates its short lines with the device literal sweep."""
    stack = [filt]
    while stack:
        f = stack.pop()
        if isinstance(f, IncludeExcludeFilter):
            stack += [s for s in (f.include, f.exclude) if s is not None]
        elif getattr(f, "_sweep_tables", None) is not None:
            return True
    return False


def _load_kernels(device) -> None:
    """Build (at first use) and load the CUDA libraries the engine
    launches; nothing on the CPU, where the plain versions run."""
    if device.type != "cuda":
        return
    from klogs_tpu_torch.ops import _build

    for name in ("nfa_kernels", "pack_kernels"):
        _build.load(name)


def _read_tls(path: str, what: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        # ValueError: __main__'s one-line path.
        raise ValueError(f"cannot read {what} {path}: {e}") from e


def _client_host(peer: str) -> str:
    """gRPC peer -> the client label, its host only: ports change with
    every connection and would mint a series each."""
    if peer.startswith(("ipv4:", "ipv6:")):
        return peer.split(":", 1)[1].rsplit(":", 1)[0]
    return peer or "unknown"


class FilterServer:
    """``device=None`` means ``"cuda"`` and raises without a card; tests
    pass ``"cpu"`` (the kernels' plain versions)."""

    def __init__(self, patterns: list[str], backend: str = "cuda",
                 host: str = "127.0.0.1", port: int = 50051,
                 ignore_case: bool = False,
                 tls_cert: str | None = None, tls_key: str | None = None,
                 tls_client_ca: str | None = None,
                 auth_token: str | None = None,
                 auth_token_file: str | None = None,
                 exclude: "list[str] | None" = None,
                 metrics_port: int | None = None,
                 metrics_host: str = "127.0.0.1",
                 registry=None,
                 device=None):
        if backend != "cuda":
            raise ValueError(f"unknown filter backend {backend!r}")
        if bool(tls_cert) != bool(tls_key):
            raise ValueError(
                "tls_cert and tls_key must be provided together "
                "(refusing to fall back to plaintext on partial TLS config)")
        if tls_client_ca and not tls_cert:
            raise ValueError("tls_client_ca (mTLS) requires tls_cert/tls_key")
        if auth_token and auth_token_file:
            raise ValueError("pass auth_token OR auth_token_file, not both")
        self.patterns = list(patterns)
        self.exclude = list(exclude or [])
        if not self.patterns and not self.exclude:
            raise ValueError("need at least one --match or --exclude pattern")
        from klogs_tpu_torch.ops.nfa import resolve_device

        self.device = resolve_device(device)
        self.backend = backend
        self.host = host
        self.port = port
        self.ignore_case = ignore_case
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self.tls_client_ca = tls_client_ca
        self.auth_token = auth_token
        self.auth_token_file = auth_token_file
        # The sidecar (--metrics-port): its registry backs the stats and
        # the engine, coalescer and RPC families, so /metrics is one
        # panel over the live pipeline. Without it nothing is counted.
        self.metrics_port = metrics_port
        self.metrics_host = metrics_host
        self.registry = None
        self.health = None
        self._stats = None
        self._http = None
        self._warmup_task: asyncio.Task | None = None
        self._m_rpc = None
        if metrics_port is not None:
            from klogs_tpu_torch import obs
            from klogs_tpu_torch.filters.base import FilterStats
            from klogs_tpu_torch.obs import trace

            # A registry of this server's own by default: a restarted
            # in-process filterd starts at zero.
            self.registry = registry if registry is not None else obs.Registry()
            obs.register_all(self.registry)
            self.registry.family("klogs_build_info").labels(
                version=BUILD_VERSION).set(1)
            # The tracer is the process's; this server's sidecar counts
            # its spans (a later server rebinds).
            trace.TRACER.bind_registry(self.registry)
            trace.RECORDER.bind_registry(self.registry)
            PROFILER.bind_registry(self.registry)
            self._stats = FilterStats(registry=self.registry)
            self._m_rpc = {
                "req": self.registry.family("klogs_rpc_requests_total"),
                "err": self.registry.family("klogs_rpc_errors_total"),
                "lat": self.registry.family("klogs_rpc_request_seconds"),
                "client": self.registry.family(
                    "klogs_rpc_client_requests_total"),
            }
            self.health = obs.Health()
            # Live while the coalescer takes work; a cold one is live.
            self.health.add_live_check(
                "coalescer", lambda: not self._service._closed)
        # Offered and admitted lines and the headroom, in every Hello
        # with or without the sidecar, and on /profile.
        self.capacity = FleetCapacity(registry=self.registry)
        PROFILER.attach_capacity(self.capacity)
        self._filter = _make_filter(self.patterns, ignore_case=ignore_case,
                                    exclude=self.exclude, stats=self._stats,
                                    device=self.device)
        self._service = AsyncFilterService(self._filter, stats=self._stats)
        self._server: grpc.aio.Server | None = None

    @property
    def device_sweep(self) -> bool:
        """Whether the device literal sweep gates this server's kernel
        (the thousand-pattern path), in Hello: an operator sees which
        servers run it without scraping each sidecar."""
        return _uses_device_sweep(self._filter)

    @property
    def auth_enabled(self) -> bool:
        return bool(self.auth_token or self.auth_token_file)

    def _current_token(self) -> str | None:
        if self.auth_token_file:
            # Read at each check: a rotated mounted Secret keeps working.
            try:
                with open(self.auth_token_file) as f:
                    return f.read().strip() or None
            except OSError:
                return None
        return self.auth_token

    async def _check_auth(self, context) -> bool:
        if not self.auth_enabled:
            return True
        # The token file is disk I/O on each RPC: off the loop, or a
        # slow Secret volume stalls every collector.
        if self.auth_token_file:
            token = await asyncio.to_thread(self._current_token)
        else:
            token = self.auth_token
        meta = dict(context.invocation_metadata() or ())
        got = meta.get("authorization", "")
        # Bytes: compare_digest on a non-ASCII str raises TypeError.
        if token and hmac.compare_digest(
                got.encode(), f"Bearer {token}".encode()):
            return True
        await context.abort(grpc.StatusCode.UNAUTHENTICATED,
                            "missing or wrong bearer token")
        return False  # not reached: abort raises

    def _instrumented(self, method: str, handler):
        """Requests, errors and latency by method, and requests by
        client host; the handler itself when metrics are off."""
        if self._m_rpc is None:
            return handler
        from klogs_tpu_torch.obs.trace import TRACER

        m = self._m_rpc
        req = m["req"].labels(method=method)
        err = m["err"].labels(method=method)
        lat = m["lat"].labels(method=method)

        async def wrapped(request: bytes, context) -> bytes:
            t0 = time.perf_counter()
            req.inc()
            m["client"].labels(
                client=_client_host(context.peer() or "")).inc()
            try:
                return await handler(request, context)
            except BaseException:
                # An abort (UNAUTHENTICATED, INVALID_ARGUMENT) is a
                # failed RPC too.
                err.inc()
                raise
            finally:
                # The rpc.server span is still open here (_traced wraps
                # this layer): the sample links to its trace.
                lat.observe(time.perf_counter() - t0,
                            exemplar=TRACER.exemplar())

        return wrapped

    def _traced(self, method: str, handler):
        """The outermost layer: an ``rpc.server`` span parented under
        the caller's ``rpc.client`` span when the metadata carries its
        traceparent, else a root under local sampling; the bare handler
        when neither side records."""
        from klogs_tpu_torch.obs.trace import TRACER

        async def wrapped(request: bytes, context) -> bytes:
            ctx = transport.extract_trace(context.invocation_metadata())
            if ctx is None and not TRACER.enabled:
                return await handler(request, context)
            with TRACER.span("rpc.server", parent=ctx, method=method,
                             request_bytes=len(request)):
                return await handler(request, context)

        return wrapped

    async def _warmup(self) -> None:
        """The gate of /readyz: one small framed batch through the
        coalescer and the engine proves the kernels load, the card
        answers and the coalescer runs."""
        from klogs_tpu_torch.filters.base import frame_lines

        try:
            payload, offsets, _ = frame_lines([b"klogs-warmup probe"])
            await self._service.match_framed(payload, offsets)
            # mark_warm, not set_ready: a drain that raced the warmup
            # stays.
            self.health.mark_warm()
        except Exception as e:  # noqa: BLE001 - reported; /readyz says it
            print(f"klogs filterd: warmup batch failed ({e}); "
                  "/readyz stays unready", flush=True)

    def _capacity_keys(self) -> dict:
        cap = self.capacity.doc()
        return {
            "headroom": cap["headroom"],
            "fleet_offered_lines": cap["offered_lines"],
            "fleet_admitted_lines": cap["admitted_lines"],
        }

    async def _hello(self, request: bytes, context) -> bytes:
        await self._check_auth(context)
        return transport.pack({
            **self._capacity_keys(),
            "patterns": self.patterns,
            "exclude": self.exclude,
            "ignore_case": self.ignore_case,
            "backend": self.backend,
            "version": BUILD_VERSION,
            "framed": True,
            # Where /readyz lives (None without the sidecar), so a
            # collector can drain this server on a rolling restart; a
            # loopback host tells a remote collector not to probe it.
            "metrics_port": self.metrics_port,
            "metrics_host": self.metrics_host,
            "device_sweep": self.device_sweep,
        })

    async def _match(self, request: bytes, context) -> bytes:
        await self._check_auth(context)
        try:
            lines, _ = transport.decode_match_request(request)
        except (ValueError, KeyError, TypeError) as e:
            # A malformed request fails its own RPC with a clean status.
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"bad match request: {e}")
        # Offered before the work, admitted once the verdicts are back.
        self.capacity.note_offered(len(lines))
        mask = await self._service.match(lines)
        self.capacity.note_admitted(len(lines))
        return transport.encode_match_response(mask)

    async def _match_framed(self, request: bytes, context) -> bytes:
        """The framed path: payload and offsets in, one byte a verdict
        out, and no per-line Python object on the server."""
        await self._check_auth(context)
        try:
            payload, offsets, _ = transport.decode_framed_request(request)
        except (ValueError, KeyError, TypeError) as e:
            # Checked here, so it never reaches the shared coalescer.
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"bad framed request: {e}")
        n_lines = max(len(offsets) - 1, 0)
        self.capacity.note_offered(n_lines)
        mask = await self._service.match_framed(payload, offsets)
        self.capacity.note_admitted(n_lines)
        return transport.encode_framed_response(mask)

    async def start(self) -> int:
        """Load the kernels, bind and serve; returns the bound port (the
        OS's pick for port 0)."""
        await asyncio.to_thread(_load_kernels, self.device)
        handler = grpc.method_handlers_generic_handler(
            transport.SERVICE,
            {name: grpc.unary_unary_rpc_method_handler(
                self._traced(name, self._instrumented(name, fn)))
             for name, fn in (("Hello", self._hello),
                              ("Match", self._match),
                              ("MatchFramed", self._match_framed))},
        )
        self._server = grpc.aio.server(options=[
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
        ])
        self._server.add_generic_rpc_handlers((handler,))
        # "unix:/path.sock" binds a Unix domain socket (a collector on
        # the same host); the port means nothing there.
        if self.host.startswith("unix:"):
            addr = self.host
        else:
            addr = f"{self.host}:{self.port}"
        if self.tls_cert and self.tls_key:
            # start() runs on the loop: the reads go through a thread.
            key = await asyncio.to_thread(_read_tls, self.tls_key,
                                          "TLS key")
            cert = await asyncio.to_thread(_read_tls, self.tls_cert,
                                           "TLS certificate")
            ca = (await asyncio.to_thread(_read_tls, self.tls_client_ca,
                                          "client CA bundle")
                  if self.tls_client_ca else None)
            creds = grpc.ssl_server_credentials(
                [(key, cert)], root_certificates=ca,
                require_client_auth=ca is not None)
            self.port = self._server.add_secure_port(addr, creds)
        else:
            self.port = self._server.add_insecure_port(addr)
        await self._server.start()
        if self.metrics_port is not None:
            from klogs_tpu_torch.obs import MetricsHTTPServer

            self._http = MetricsHTTPServer(
                self.registry, health=self.health,
                host=self.metrics_host, port=self.metrics_port)
            try:
                self.metrics_port = await self._http.start()
            except BaseException as e:
                # An unbindable port, or a cancellation mid-bind: stop
                # the started gRPC server (serve()'s finally is not
                # armed yet); OSError becomes the one-line ValueError.
                self._http = None
                await self._server.stop(0)
                await self._service.aclose()
                if isinstance(e, OSError):
                    raise ValueError(
                        f"cannot bind metrics port "
                        f"{self.metrics_host}:{self.metrics_port}: {e}"
                    ) from e
                raise
            # Ready when the warmup batch lands, not here: /readyz
            # answers 503 until then while /healthz answers 200.
            self._warmup_task = asyncio.get_running_loop().create_task(
                self._warmup())
        return self.port

    async def wait(self) -> None:
        await self._server.wait_for_termination()

    async def stop(self, grace: float = 1.0) -> None:
        if self._warmup_task is not None:
            self._warmup_task.cancel()
            try:
                await self._warmup_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._warmup_task = None
        if self._http is not None:
            await self._http.stop()
            self._http = None
        if self._server is not None:
            await self._server.stop(grace)
        # Drains the in-flight batches, then releases the engine.
        await self._service.aclose()


def banner_line(server: "FilterServer", where: str, mode: str) -> str:
    """The startup 'serving ...' line."""
    return (f"klogs filterd: serving {len(server.patterns)} pattern(s) "
            f"[{server.backend}] on {where} ({mode})")


async def serve(patterns: list[str], backend: str, host: str, port: int,
                ignore_case: bool = False,
                trace_json: "str | None" = None,
                profile_json: "str | None" = None,
                device=None, **security) -> None:
    from klogs_tpu_torch.obs import trace

    if trace_json is not None:
        # Server-side spans (rooted at rpc.server, or continuing a
        # collector's trace) as JSON lines; /traces serves them too.
        trace.TRACER.enable_default()
        trace.TRACER.set_json_path(trace_json)
    # --profile-json turns the profiler on (unless KLOGS_PROFILE_SAMPLE
    # pins a rate, 0 included); the variable alone feeds /profile.
    PROFILER.maybe_enable()
    if profile_json is not None and PROFILER.enable():
        PROFILER.set_json_path(profile_json)
    server = FilterServer(patterns, backend, host=host, port=port,
                          ignore_case=ignore_case, device=device,
                          **security)
    bound = await server.start()
    prof_stop: "asyncio.Event | None" = None
    prof_task: "asyncio.Task | None" = None
    # Everything after start() is under the finally: a raise in the
    # banner or the ticker must not leak the listener.
    try:
        if PROFILER.enabled:
            prof_stop = asyncio.Event()
            prof_task = asyncio.get_running_loop().create_task(
                PROFILER.run_ticker(prof_stop))
        mode = "TLS" if server.tls_cert else "plaintext"
        if server.tls_client_ca:
            mode = "mTLS"
        if server.auth_enabled:
            mode += "+bearer"
            if not server.tls_cert:
                print("klogs filterd: WARNING bearer auth over plaintext "
                      "sends the token in the clear; add --tls-cert/"
                      "--tls-key on untrusted networks", flush=True)
        where = (server.host if server.host.startswith("unix:")
                 else f"{server.host}:{bound}")
        print(banner_line(server, where, mode), flush=True)
        if server.metrics_port is not None:
            print(f"klogs filterd: metrics on http://{server.metrics_host}:"
                  f"{server.metrics_port}/metrics (health: /healthz, "
                  "readiness: /readyz)", flush=True)
        await server.wait()
    finally:
        try:
            await server.stop()
        finally:
            # Nested, so a cancellation inside server.stop() still reaps
            # the ticker.
            if prof_task is not None:
                # Its last tick ends the JSON-lines file.
                prof_stop.set()
                try:
                    await prof_task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
                PROFILER.set_json_path(None)
            # A degrade trigger armed near shutdown may have no root
            # span left to ride.
            trace.RECORDER.flush()
