"""filterd: the process that owns the card and serves Match RPCs.

Counterpart of ``klogs_tpu/service/server.py``. Single-set, one pattern
set (``--match``/``--exclude``/``-I``) on one GpuEngineFilter: ``python
-m klogs_tpu_torch.service --backend cuda --match ERROR --port 50051``.
Every client's batches go through one AsyncFilterService, so concurrent
collectors coalesce into shared device batches however small each
one's flushes are. ``--backend cpu`` serves the host engines instead
(filters/cpu.py ``best_host_filter``: indexed, DFA, combined re, re),
behind the same service, and never touches the card; its C module is
built (at first use) before the port binds, as the CUDA libraries are
for ``cuda``.

With ``--multi-set`` (``multi_set=True``) the server holds a registry of
pattern sets (``tenancy.py``): a collector registers its set with the
Register RPC and tags its match RPCs with the set id it got back; each
set has its own engine (a GpuEngineFilter on the same card, or the
host engines under ``--backend cpu``), built in a worker thread at its
first registration, and all sets share one fetch pool and one
in-flight budget. The startup set, if any, is a pinned set for
collectors that do not register. A set over its quota is shed
(RESOURCE_EXHAUSTED), an unknown or evicted one fails
FAILED_PRECONDITION, and an engine that does not build fails its
Register RPC: there is no CPU engine behind a card's server.

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
error, never a plaintext fallback.

With the sidecar's registry, filterd also times its host path, always
on: the event loop's lag (``klogs_loop_lag_seconds``: a timer re-armed
every 50 ms, from ``start`` to ``stop``, observes how late it fired)
and each RPC's receive (``klogs_rpc_receive_seconds{method}``: from its
arrival, stamped when grpc looks its handler up, before the request
message is read, to the handler's entry). A sampled RPC's receive is
also an ``rpc.receive`` span, a child of its ``rpc.server`` span that
ends where it starts.
"""

import asyncio
import contextvars
import hmac
import time

import grpc

from klogs_tpu_torch.filters.async_service import AsyncFilterService
from klogs_tpu_torch.filters.base import IncludeExcludeFilter
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.obs.profiler import PROFILER, FleetCapacity
from klogs_tpu_torch.service import transport
from klogs_tpu_torch.service.client import MAX_MESSAGE_BYTES
from klogs_tpu_torch.version import BUILD_VERSION


def _make_filter(patterns: list[str], ignore_case: bool = False,
                 exclude: "list[str] | None" = None, stats=None,
                 device=None, backend: str = "cuda"):
    """The include/exclude engine: the GPU engine on ``device``, or for
    ``backend="cpu"`` the host engines. The stats (and the host
    engines' families) ride the first side built only (feeding both
    would count twice)."""
    from klogs_tpu_torch.filters.base import build_include_exclude

    made = []

    def one(pats):
        if backend == "cpu":
            from klogs_tpu_torch.filters.cpu import best_host_filter

            f = best_host_filter(
                pats, ignore_case=ignore_case,
                registry=stats.registry
                if stats is not None and not made else None)[0]
        else:
            from klogs_tpu_torch.filters.gpu import GpuEngineFilter

            f = GpuEngineFilter(pats, ignore_case=ignore_case,
                                device=device,
                                stats=stats if not made else None)
        made.append(f)
        return f

    return build_include_exclude(one, patterns, exclude)


def _uses_device_sweep(filt) -> bool:
    """Whether an engine behind ``filt`` (perhaps an include/exclude
    pair) runs the device literal sweep: the GPU engine's gate (or its
    mesh engine's), or an IndexedFilter narrowing on the card (and not
    bypassed: a stream switched to scan-all sweeps nothing)."""
    stack = [filt]
    while stack:
        f = stack.pop()
        if isinstance(f, IncludeExcludeFilter):
            stack += [s for s in (f.include, f.exclude) if s is not None]
        elif (getattr(f, "_sweep_tables", None) is not None
              and getattr(f, "_sweep_path", "device") == "device"
              and not getattr(f, "bypassed", False)):
            return True
        elif getattr(getattr(f, "_engine", None), "swept", False):
            # A mesh engine holds the sweep in its shards.
            return True
    return False


def _load_kernels(device, backend: str = "cuda") -> None:
    """Build (at first use) and load what the engine runs: the host C
    for ``backend="cpu"``, the CUDA libraries on a card, nothing on the
    CPU, where the plain versions run. On a card, then anchor its clock
    (``filters/gpu.py`` ``CardClock``) while it is idle."""
    if backend == "cpu":
        from klogs_tpu_torch.native import hostops

        hostops()
        return
    if device.type != "cuda":
        return
    from klogs_tpu_torch.ops import _build

    from klogs_tpu_torch.filters.gpu import anchor_card_clock

    for name in ("nfa_kernels", "pack_kernels"):
        _build.load(name)
    anchor_card_clock(device)


# The arrival of the RPC the current task serves (``time.perf_counter``).
_ARRIVED: "contextvars.ContextVar[float | None]" = contextvars.ContextVar(
    "klogs_rpc_arrived", default=None)


class _Arrivals(grpc.GenericRpcHandler):
    """Stamps each RPC's arrival in ``_ARRIVED``: grpc.aio looks the
    handler up in the RPC's own task, once its headers are in and before
    its request message is read."""

    def __init__(self, inner) -> None:
        self._inner = inner

    def service(self, handler_call_details):
        _ARRIVED.set(time.perf_counter())
        return self._inner.service(handler_call_details)


class LoopLag:
    """The event loop's lag: a timer re-armed every ``period_s`` observes
    in ``histogram`` how late it fired (asyncio's millisecond poll
    timeout puts a floor of up to 1 ms under it)."""

    def __init__(self, histogram, period_s: float = 0.05) -> None:
        self._hist = histogram
        self.period_s = period_s
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._handle: "asyncio.TimerHandle | None" = None
        self._due = 0.0

    @property
    def running(self) -> bool:
        return self._handle is not None

    def start(self, loop: "asyncio.AbstractEventLoop") -> None:
        self._loop = loop
        self._arm()

    def stop(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def _arm(self) -> None:
        self._due = self._loop.time() + self.period_s
        self._handle = self._loop.call_at(self._due, self._fire)

    def _fire(self) -> None:
        self._hist.observe(max(0.0, self._loop.time() - self._due))
        self._arm()


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
    pass ``"cpu"`` (the kernels' plain versions). ``backend="cpu"``
    serves the host engines and reads no device."""

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
                 multi_set: bool = False,
                 tenant_max_sets: "int | None" = None,
                 tenant_quota_lines: "int | None" = None,
                 tenant_idle_s: "float | None" = None,
                 device=None):
        if backend not in ("cuda", "cpu"):
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
        self.multi_set = multi_set
        if not self.patterns and not self.exclude and not multi_set:
            raise ValueError("need at least one --match or --exclude pattern")
        if backend == "cpu":
            import torch

            # The host engines: the card is never touched.
            self.device = torch.device("cpu")
        else:
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
        self._loop_lag: "LoopLag | None" = None
        if metrics_port is not None:
            from klogs_tpu_torch import obs
            from klogs_tpu_torch.filters.base import FilterStats

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
                "receive": self.registry.family("klogs_rpc_receive_seconds"),
            }
            self._loop_lag = LoopLag(
                self.registry.family("klogs_loop_lag_seconds"))
            self.health = obs.Health()
            # Live while the coalescer takes work; a cold one is live.
            self.health.add_live_check(
                "coalescer", lambda: self._service is None
                or not self._service._closed)
        # Offered and admitted lines and the headroom, in every Hello
        # with or without the sidecar, and on /profile.
        self.capacity = FleetCapacity(registry=self.registry)
        PROFILER.attach_capacity(self.capacity)
        # The registry's sets build on the server's device and stats.
        self.tenants = None
        self.default_set: "str | None" = None
        self._sweep_task: asyncio.Task | None = None
        self._sweep_stop: "asyncio.Event | None" = None
        if multi_set:
            from klogs_tpu_torch.service.tenancy import PatternSetRegistry

            def factory(pats: list[str], excl: list[str], ic: bool):
                return _make_filter(pats, ignore_case=ic, exclude=excl,
                                    stats=self._stats, device=self.device,
                                    backend=backend)

            self.tenants = PatternSetRegistry(
                factory, stats=self._stats, max_sets=tenant_max_sets,
                quota_lines=tenant_quota_lines, idle_evict_s=tenant_idle_s)
        # The startup set; a registry-only server has none. Under the
        # registry it rides the shared pool and budget as a pinned set.
        self._filter = None
        self._service = None
        if self.patterns or self.exclude:
            self._filter = _make_filter(self.patterns,
                                        ignore_case=ignore_case,
                                        exclude=self.exclude,
                                        stats=self._stats,
                                        device=self.device,
                                        backend=backend)
            shared = ({} if self.tenants is None
                      else dict(executor=self.tenants.executor,
                                in_flight=self.tenants.in_flight))
            self._service = AsyncFilterService(self._filter,
                                               stats=self._stats, **shared)
            if self.tenants is not None:
                self.default_set = self.tenants.adopt(
                    self.patterns, self.exclude, self.ignore_case,
                    self._service)
        self._server: grpc.aio.Server | None = None

    @property
    def device_sweep(self) -> bool:
        """Whether the device literal sweep gates this server's kernel
        (the thousand-pattern path), in Hello: an operator sees which
        servers run it without scraping each sidecar. Under the
        registry any registered set's engine counts."""
        if self._filter is not None and _uses_device_sweep(self._filter):
            return True
        if self.tenants is not None:
            return any(not e.pinned and _uses_device_sweep(e.service._filter)
                       for e in self.tenants.entries())
        return False

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
        when neither side records. Its entry ends the RPC's receive,
        observed with metrics, and when the ``rpc.server`` span samples,
        an ``rpc.receive`` child that ends where it starts."""
        from klogs_tpu_torch.obs.trace import TRACER

        receive = (self._m_rpc["receive"].labels(method=method)
                   if self._m_rpc is not None else None)

        async def wrapped(request: bytes, context) -> bytes:
            arrived = _ARRIVED.get()
            waited = (time.perf_counter() - arrived
                      if arrived is not None else None)
            if waited is not None and receive is not None:
                receive.observe(waited)
            ctx = transport.extract_trace(context.invocation_metadata())
            if ctx is None and not TRACER.enabled:
                return await handler(request, context)
            with TRACER.span("rpc.server", parent=ctx, method=method,
                             request_bytes=len(request)) as sp:
                if waited is not None and sp.sampled:
                    TRACER.record_span("rpc.receive", sp,
                                       sp.start_unix - waited, waited,
                                       method=method)
                return await handler(request, context)

        return wrapped

    async def _warmup(self) -> None:
        """The gate of /readyz: one small framed batch through the
        coalescer and the engine proves the kernels load, the card
        answers and the coalescer runs."""
        from klogs_tpu_torch.filters.base import frame_lines

        try:
            if self._service is None:
                # A registry-only server: each registration builds its
                # own engine, so it is ready once bound.
                self.health.mark_warm()
                return
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
        if self.tenants is not None:
            return await self._hello_multi(request)
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

    async def _hello_multi(self, request: bytes) -> bytes:
        """The registry's Hello: a request carrying the collector's
        invocation is answered for that set (echoed when registered, so
        the client's check passes); the empty Hello gets the startup
        set. ``multi_set`` tells the client to register."""
        from klogs_tpu_torch.service.shard import pattern_fingerprint

        want = transport.decode_hello_request(request)
        patterns, exclude, ignore_case = (self.patterns, self.exclude,
                                          self.ignore_case)
        set_id: "str | None" = self.default_set
        registered = self.default_set is not None
        if want is not None:
            set_id = pattern_fingerprint(want["patterns"], want["exclude"],
                                         want["ignore_case"])
            entry = self.tenants.get(set_id)
            registered = entry is not None
            if registered:
                patterns = entry.patterns
                exclude = entry.exclude
                ignore_case = entry.ignore_case
        sp = trace.TRACER.current_span()
        if sp is not None and set_id is not None:
            sp.set_attr("tenant", set_id)
        return transport.pack({
            **self._capacity_keys(),
            "patterns": patterns,
            "exclude": exclude,
            "ignore_case": ignore_case,
            "backend": self.backend,
            "version": BUILD_VERSION,
            "framed": True,
            "metrics_port": self.metrics_port,
            "metrics_host": self.metrics_host,
            "device_sweep": self.device_sweep,
            "multi_set": True,
            "sets": self.tenants.count,
            "set": set_id,
            "registered": registered,
        })

    async def _register(self, request: bytes, context) -> bytes:
        """Register a set (content-addressed: a second registration of
        a set shares its engine). A set that does not compile is
        INVALID_ARGUMENT; an engine that fails to build on the card
        fails this RPC with its error."""
        await self._check_auth(context)
        if self.tenants is None:
            await context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "this filterd runs in single-set mode (start it with "
                "--multi-set to accept registrations)")
        try:
            req = transport.decode_register_request(request)
        except (ValueError, KeyError, TypeError) as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"bad register request: {e}")
        try:
            set_id, shared = await self.tenants.register(
                req["patterns"], req["exclude"], req["ignore_case"],
                weight=req["weight"])
        except ValueError as e:
            # The tenant's own set is broken; nobody else's fails.
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"cannot compile pattern set: {e}")
        sp = trace.TRACER.current_span()
        if sp is not None:
            sp.set_attr("tenant", set_id)
        return transport.encode_register_response(
            set_id, shared, self.tenants.count)

    async def _tenant_match(self, set_id: "str | None", context, run):
        """One match RPC through the registry: its set, else the
        startup set; over quota RESOURCE_EXHAUSTED, an unknown or
        evicted set FAILED_PRECONDITION (the client registers again)."""
        from klogs_tpu_torch.service.tenancy import (
            OverQuota,
            SetNotRegistered,
        )

        lane = set_id if set_id is not None else self.default_set
        if lane is None:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{transport.SET_NOT_REGISTERED}: this multi-set "
                "filterd has no default pattern set; register one "
                "first")
        sp = trace.TRACER.current_span()
        if sp is not None:
            sp.set_attr("tenant", lane)
        try:
            return await run(lane)
        except OverQuota as e:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                f"{transport.OVER_QUOTA}: {e}")
        except SetNotRegistered as e:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{transport.SET_NOT_REGISTERED}: {e}")

    async def _match(self, request: bytes, context) -> bytes:
        await self._check_auth(context)
        try:
            lines, set_id = transport.decode_match_request(request)
        except (ValueError, KeyError, TypeError) as e:
            # A malformed request fails its own RPC with a clean status.
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"bad match request: {e}")
        # Offered before admission, admitted once the verdicts are back:
        # a shed batch is the gap between the two.
        self.capacity.note_offered(len(lines))
        if self.tenants is not None:
            mask = await self._tenant_match(
                set_id, context,
                lambda lane: self.tenants.match(lane, lines))
        else:
            mask = await self._service.match(lines)
        self.capacity.note_admitted(len(lines))
        return transport.encode_match_response(mask)

    async def _match_framed(self, request: bytes, context) -> bytes:
        """The framed path: payload and offsets in, one byte a verdict
        out, and no per-line Python object on the server."""
        await self._check_auth(context)
        try:
            payload, offsets, set_id = transport.decode_framed_request(
                request)
        except (ValueError, KeyError, TypeError) as e:
            # Checked here, so it never reaches the shared coalescer.
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                f"bad framed request: {e}")
        n_lines = max(len(offsets) - 1, 0)
        self.capacity.note_offered(n_lines)
        if self.tenants is not None:
            mask = await self._tenant_match(
                set_id, context,
                lambda lane: self.tenants.match_framed(
                    lane, payload, offsets))
        else:
            mask = await self._service.match_framed(payload, offsets)
        self.capacity.note_admitted(n_lines)
        return transport.encode_framed_response(mask)

    async def start(self) -> int:
        """Load the kernels, bind and serve; returns the bound port (the
        OS's pick for port 0)."""
        await asyncio.to_thread(_load_kernels, self.device, self.backend)
        handler = grpc.method_handlers_generic_handler(
            transport.SERVICE,
            {name: grpc.unary_unary_rpc_method_handler(
                self._traced(name, self._instrumented(name, fn)))
             for name, fn in (("Hello", self._hello),
                              ("Match", self._match),
                              ("MatchFramed", self._match_framed),
                              ("Register", self._register))},
        )
        self._server = grpc.aio.server(options=[
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
        ])
        self._server.add_generic_rpc_handlers((_Arrivals(handler),))
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
                await self._close_sets()
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
        if self.tenants is not None and self.tenants.idle_evict_s > 0:
            # The cold-set reaper: an idle set's engine is released.
            self._sweep_stop = asyncio.Event()
            self._sweep_task = asyncio.get_running_loop().create_task(
                self.tenants.run_idle_sweeper(self._sweep_stop))
        if self._loop_lag is not None:
            self._loop_lag.start(asyncio.get_running_loop())
        return self.port

    async def wait(self) -> None:
        await self._server.wait_for_termination()

    async def stop(self, grace: float = 1.0) -> None:
        if self._loop_lag is not None:
            self._loop_lag.stop()
        if self._warmup_task is not None:
            self._warmup_task.cancel()
            try:
                await self._warmup_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._warmup_task = None
        if self._sweep_task is not None:
            self._sweep_stop.set()
            self._sweep_task.cancel()
            try:
                await self._sweep_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._sweep_task = None
        if self._http is not None:
            await self._http.stop()
            self._http = None
        if self._server is not None:
            await self._server.stop(grace)
        await self._close_sets()

    async def _close_sets(self) -> None:
        """Drain the in-flight batches and release the engines: the
        startup set's service (the server's own, under the registry
        too), then the registered sets and their shared pool."""
        if self._service is not None:
            await self._service.aclose()
        if self.tenants is not None:
            await self.tenants.aclose()


def banner_line(server: "FilterServer", where: str, mode: str) -> str:
    """The startup 'serving ...' line; under the registry its live set
    count and cap."""
    if server.tenants is not None:
        return (f"klogs filterd: serving pattern-set registry "
                f"({server.tenants.count} live set(s), cap "
                f"{server.tenants.max_sets}) [{server.backend}] on "
                f"{where} ({mode})")
    return (f"klogs filterd: serving {len(server.patterns)} pattern(s) "
            f"[{server.backend}] on {where} ({mode})")


async def serve(patterns: list[str], backend: str, host: str, port: int,
                ignore_case: bool = False,
                trace_json: "str | None" = None,
                profile_json: "str | None" = None,
                multi_set: bool = False, device=None, **security) -> None:
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
                          ignore_case=ignore_case, multi_set=multi_set,
                          device=device, **security)
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
