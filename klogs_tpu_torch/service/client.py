"""The remote filter client: a FilteredSink's service over gRPC.

Counterpart of ``klogs_tpu/service/client.py``. ``RemoteFilterClient``
answers ``match``/``match_framed`` as the in-process AsyncFilterService
does, so a collector gates its writes on a filterd elsewhere (the
port's, or the JAX package's) as it would on its own engine. Every RPC
is its own HTTP/2 stream on one channel, so concurrent sink flushes
overlap.

Each RPC runs under ``retry_call``: a fresh deadline an attempt
(``KLOGS_REMOTE_TIMEOUT_S`` through ``make_pipeline``), retries with
jittered backoff on UNAVAILABLE and DEADLINE_EXCEEDED, and one circuit
breaker a client. Exhausted retries or an open breaker raise
``Unavailable``, which the sink routes per ``--on-filter-error``. The
``rpc.hello`` and ``rpc.match`` fault points fire inside that retry
loop, for this client's endpoint (``point@host:port`` targets it).
Against a multi-set filterd (the JAX package's ``--multi-set``) the
client registers its pattern set and tags every match RPC with the set
id it got back.
"""

import asyncio
import math

import grpc
import numpy as np

from klogs_tpu_torch.cluster.backend import ClusterError
from klogs_tpu_torch.resilience import (
    CircuitBreaker,
    RetryPolicy,
    Unavailable,
    retry_call,
)
from klogs_tpu_torch.service import transport

# Transient failures worth retrying: the server restarts or the stream
# dropped (UNAVAILABLE), or one attempt overran its deadline. A bad
# request, auth or resource exhaustion is not fixed by a retry.
_RETRYABLE_CODES = (grpc.StatusCode.UNAVAILABLE,
                    grpc.StatusCode.DEADLINE_EXCEEDED)

DEFAULT_RETRY = RetryPolicy(max_attempts=4, base_s=0.25, max_s=5.0,
                            jitter=0.1)
DEFAULT_BREAKER_THRESHOLD = 5
DEFAULT_BREAKER_RESET_S = 10.0
# gRPC's 4 MB default message cap is below a jumbo batch of long lines.
MAX_MESSAGE_BYTES = 256 * 1024 * 1024
# The one line for a --remote list until the sharded tier is ported.
REMOTE_LIST_ERROR = ("--remote takes one HOST:PORT in klogs_tpu_torch: "
                     "a list of filterd endpoints (the sharded tier) is "
                     "not ported yet")


def _retryable(e: BaseException) -> bool:
    return (isinstance(e, grpc.aio.AioRpcError)
            and e.code() in _RETRYABLE_CODES)


class PatternMismatch(RuntimeError):
    pass


class ShedByServer(Unavailable):
    """A multi-set filterd shed this batch over its set's quota
    (RESOURCE_EXHAUSTED). An Unavailable, so the batch takes the
    ``--on-filter-error`` path and is counted, never dropped quietly."""


class SetEvicted(ClusterError):
    """The server no longer holds this client's registered set
    (FAILED_PRECONDITION): the client registers once more and retries."""


class ServiceConfigError(ValueError):
    """Invalid or partial transport-security configuration, or
    credentials that cannot be read: one line from the CLI, never a
    plaintext fallback."""


def _read(path: str, what: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise ServiceConfigError(f"cannot read {what} {path}: {e}") from e


def validate_target(target: str) -> None:
    """A ``--remote`` endpoint must be HOST:PORT or unix:/path.sock;
    a malformed one fails naming itself, not as a gRPC error later."""
    if target.startswith("unix:"):
        if len(target) == len("unix:"):
            raise ServiceConfigError(
                f"malformed --remote endpoint {target!r}: empty unix "
                "socket path")
        return
    host, sep, port = target.rpartition(":")
    if not sep or not host:
        raise ServiceConfigError(
            f"malformed --remote endpoint {target!r} (want HOST:PORT "
            "or unix:/path.sock)")
    if not port.isdigit() or not 0 < int(port) < 65536:
        raise ServiceConfigError(
            f"malformed --remote endpoint {target!r}: bad port {port!r}")


def tenant_weight() -> float:
    """The weighted-fair share this collector asks a multi-set filterd
    for at registration (``KLOGS_TENANT_WEIGHT``, default 1.0); a bad
    value fails naming the variable."""
    from klogs_tpu_torch.utils.env import read as env_read

    raw = env_read("KLOGS_TENANT_WEIGHT")
    if raw is None:
        return 1.0
    try:
        v = float(raw)
        if not math.isfinite(v) or not 0 < v <= 1024:
            raise ValueError
    except ValueError:
        raise ServiceConfigError(
            f"KLOGS_TENANT_WEIGHT must be in (0, 1024], got {raw!r}"
        ) from None
    return v


def check_server_config(target: str, info: dict, patterns: list[str],
                        ignore_case: bool,
                        exclude: "list[str] | None") -> str:
    """A Hello response against the collector's invocation: ``"ok"``,
    or ``"register"`` when the server runs a multi-set registry (the
    collector registers its set there rather than failing). A
    single-set server with another set raises PatternMismatch naming
    ``target``."""
    if info.get("multi_set"):
        # Registration is content-addressed and idempotent, and every
        # client needs the set id it returns.
        return "register"
    if list(info.get("patterns", [])) != list(patterns):
        raise PatternMismatch(
            f"filter service at {target} serves patterns "
            f"{info.get('patterns')!r}, collector wants {patterns!r}"
        )
    if list(info.get("exclude", [])) != list(exclude or []):
        raise PatternMismatch(
            f"filter service at {target} has exclude patterns "
            f"{info.get('exclude')!r}, collector wants {exclude or []!r}"
        )
    if bool(info.get("ignore_case", False)) != bool(ignore_case):
        raise PatternMismatch(
            f"filter service at {target} has ignore_case="
            f"{info.get('ignore_case', False)!r}, collector wants "
            f"{bool(ignore_case)!r}"
        )
    return "ok"


class RemoteFilterClient:
    """``tls_ca`` switches the channel to TLS (the server checked
    against that bundle); ``tls_cert``/``tls_key`` add a client
    certificate (mTLS). ``auth_token`` (or ``auth_token_file``, read
    again for each RPC so a rotated Secret keeps working) sends
    ``authorization: Bearer <token>`` with every RPC. All are off by
    default; partial TLS configuration is an error, and a token over
    plaintext warns."""

    def __init__(self, target: str, tls_ca: str | None = None,
                 tls_cert: str | None = None, tls_key: str | None = None,
                 auth_token: str | None = None,
                 auth_token_file: str | None = None,
                 retry: "RetryPolicy | None" = None,
                 breaker: "CircuitBreaker | None" = None,
                 rpc_timeout_s: "float | None" = 30.0,
                 registry=None):
        if (tls_cert or tls_key) and not tls_ca:
            raise ServiceConfigError(
                "tls_cert/tls_key (mTLS) require tls_ca — refusing to "
                "silently open an insecure channel")
        if bool(tls_cert) != bool(tls_key):
            raise ServiceConfigError(
                "tls_cert and tls_key must be provided together")
        if auth_token and auth_token_file:
            raise ServiceConfigError(
                "pass auth_token OR auth_token_file, not both")
        self._target = target
        if auth_token_file:
            # Fail before any channel exists or any warning prints.
            _read(auth_token_file, "bearer token file")
        options = [
            ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
            ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
        ]
        if tls_ca:
            creds = grpc.ssl_channel_credentials(
                root_certificates=_read(tls_ca, "TLS CA bundle"),
                private_key=_read(tls_key, "TLS client key") if tls_key else None,
                certificate_chain=_read(tls_cert, "TLS client cert")
                if tls_cert else None)
            self._channel = grpc.aio.secure_channel(target, creds,
                                                    options=options)
        else:
            if auth_token or auth_token_file:
                from klogs_tpu_torch.ui import term

                term.warning(
                    "bearer token to %s travels over PLAINTEXT "
                    "(set KLOGS_REMOTE_TLS_CA to encrypt the hop)", target)
            self._channel = grpc.aio.insecure_channel(target, options=options)
        self._auth_token = auth_token
        self._auth_token_file = auth_token_file
        self._match_rpc = self._channel.unary_unary(transport.MATCH)
        self._match_framed_rpc = self._channel.unary_unary(
            transport.MATCH_FRAMED)
        self._hello_rpc = self._channel.unary_unary(transport.HELLO)
        self._register_rpc = self._channel.unary_unary(transport.REGISTER)
        # None until the first Hello; a server without "framed" gets
        # match_framed as the per-line Match.
        self._server_framed: bool | None = None
        # A sync close() parks its channel close here; aclose() awaits it.
        self._close_task: "asyncio.Task | None" = None
        # A multi-set server's set id for this client's set, and the set
        # itself, to register again after an eviction.
        self._set_id: str | None = None
        self._expected_cfg: "tuple[list[str], bool, list[str]] | None" = None
        # The breaker and the retry site carry the endpoint, so each
        # server of a fleet has its own series.
        self._retry = retry if retry is not None else DEFAULT_RETRY
        self._site = f"rpc@{target}"
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            name=self._site, failure_threshold=DEFAULT_BREAKER_THRESHOLD,
            reset_timeout_s=DEFAULT_BREAKER_RESET_S, registry=registry)
        self._rpc_timeout_s = rpc_timeout_s
        self._registry = registry

    @property
    def target(self) -> str:
        return self._target

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def _metadata(self):
        token = self._auth_token
        if self._auth_token_file:
            # An unreadable token file names itself, rather than an
            # unauthenticated RPC blaming the server.
            token = _read(self._auth_token_file,
                          "bearer token file").decode().strip()
        return (("authorization", f"Bearer {token}"),) if token else None

    def _friendly(self, e: "grpc.aio.AioRpcError") -> ClusterError:
        # One line, through the CLI's ClusterError path.
        return ClusterError(
            f"filter service at {self._target}: "
            f"{e.code().name}: {e.details()}")

    async def _call(self, rpc, request: bytes, fault_point: str):
        """One guarded RPC under one ``rpc.client`` span: the breaker,
        a fresh deadline an attempt, retries on the transient codes,
        the span's context on each attempt's metadata. Exhausted
        retries or an open breaker raise ``Unavailable``; any other RPC
        error the one-line ClusterError."""
        from klogs_tpu_torch.obs.trace import TRACER

        async def attempt(deadline):
            md = tuple(self._metadata() or ()) + transport.trace_metadata()
            return await rpc(
                request, metadata=md or None,
                timeout=(deadline.remaining()
                         if deadline is not None else None))

        try:
            with TRACER.span("rpc.client", target=self._target,
                             method=fault_point) as sp:
                result = await retry_call(
                    attempt, policy=self._retry, retryable=_retryable,
                    site=self._site,
                    describe=f"filter service at {self._target}",
                    breaker=self._breaker, deadline_s=self._rpc_timeout_s,
                    fault_point=fault_point, fault_target=self._target,
                    registry=self._registry)
                sp.set_attr("response_bytes", len(result))
                return result
        except Unavailable as e:
            cause = e.__cause__
            if isinstance(cause, grpc.aio.AioRpcError):
                # The one-line CODE: details form, not gRPC's debug blob.
                raise type(e)(
                    f"filter service at {self._target}: "
                    f"{cause.code().name}: {cause.details()} "
                    f"(retries exhausted)") from cause
            raise
        except grpc.aio.AioRpcError as e:
            if (e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                    and (e.details() or "").startswith(
                        transport.OVER_QUOTA)):
                # A quota shed (keyed on the wire token: gRPC's own
                # RESOURCE_EXHAUSTED for an oversize message stays a
                # ClusterError): not retried, not a breaker failure.
                raise ShedByServer(
                    f"filter service at {self._target}: "
                    f"{e.details()}") from e
            if (e.code() == grpc.StatusCode.FAILED_PRECONDITION
                    and (e.details() or "").startswith(
                        transport.SET_NOT_REGISTERED)):
                raise SetEvicted(
                    f"filter service at {self._target}: "
                    f"{e.details()}") from e
            raise self._friendly(e) from e

    async def hello(self) -> dict:
        # With a set recorded, Hello carries it: a multi-set server then
        # answers for this set, not its default one.
        body = b""
        if self._expected_cfg is not None:
            pats, ic, excl = self._expected_cfg
            body = transport.encode_hello_request(pats, excl, ic)
        info = transport.unpack(
            await self._call(self._hello_rpc, body, "rpc.hello"))
        self._server_framed = bool(info.get("framed", False))
        return info

    async def verify_patterns(self, patterns: list[str],
                              ignore_case: bool = False,
                              exclude: "list[str] | None" = None) -> None:
        """Fail fast when the server filters with another pattern set,
        case mode or exclude set; against a multi-set server, register
        this set instead."""
        self._expected_cfg = (list(patterns), bool(ignore_case),
                              list(exclude or []))
        info = await self.hello()
        if check_server_config(self._target, info, patterns, ignore_case,
                               exclude) == "register":
            await self._register_set()

    async def ensure_registered(self, patterns: list[str],
                                ignore_case: bool = False,
                                exclude: "list[str] | None" = None
                                ) -> None:
        """Record the set and register it (idempotent), without a Hello
        first."""
        self._expected_cfg = (list(patterns), bool(ignore_case),
                              list(exclude or []))
        await self._register_set()

    async def _register_set(self) -> None:
        if self._expected_cfg is None:
            raise RuntimeError("register before verify_patterns")
        pats, ic, excl = self._expected_cfg
        resp = transport.decode_register_response(await self._call(
            self._register_rpc,
            transport.encode_register_request(
                pats, excl, ic, weight=tenant_weight()),
            "rpc.register"))
        self._set_id = resp["set"]

    async def _call_set(self, rpc, build, fault_point: str):
        """One match RPC tagged with the set id, registering once more
        if the server evicted the set while it was cold."""
        try:
            return await self._call(rpc, build(self._set_id), fault_point)
        except SetEvicted:
            if self._expected_cfg is None:
                raise
            await self._register_set()
            try:
                return await self._call(rpc, build(self._set_id),
                                        fault_point)
            except SetEvicted as e:
                # Evicted again at once: the registry is churning, an
                # overload, so degrade like any unavailability.
                raise Unavailable(
                    f"filter service at {self._target}: set evicted "
                    f"again immediately after re-registration "
                    f"(registry capacity churn): {e}") from e

    async def match(self, lines: list[bytes]) -> list[bool]:
        resp = await self._call_set(
            self._match_rpc,
            lambda sid: transport.encode_match_request(lines, set_id=sid),
            "rpc.match")
        return transport.decode_match_response(resp)

    async def match_framed(self, payload: bytes, offsets) -> np.ndarray:
        """A framed batch's verdicts as a bool array; the per-line Match
        against a server whose Hello lacks "framed"."""
        if self._server_framed is None:
            await self.hello()
        if not self._server_framed:
            from klogs_tpu_torch.filters.base import split_frame

            return np.asarray(
                await self.match(split_frame(payload, offsets)), dtype=bool)
        resp = await self._call_set(
            self._match_framed_rpc,
            lambda sid: transport.encode_framed_request(payload, offsets,
                                                        set_id=sid),
            "rpc.match")
        return transport.decode_framed_response(resp)

    async def aclose(self) -> None:
        """Close the channel inside the loop (awaited by the pipeline),
        after any close a sync ``close()`` parked."""
        pending, self._close_task = self._close_task, None
        if pending is not None:
            try:
                await pending
            except Exception:  # noqa: BLE001 - teardown goes on
                pass
        await self._channel.close()

    def close(self) -> None:
        """Sync fallback: schedule the close on the running loop (kept
        on ``_close_task``), else the channel ends with the process."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._close_task = loop.create_task(self._channel.close())
