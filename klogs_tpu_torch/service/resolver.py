"""Endpoint resolvers: the live membership of the sharded tier.

Counterpart of ``klogs_tpu/service/resolver.py``. A ``--remote`` list is
fixed when the collector starts; a ``Resolver`` is polled by
``ShardedFilterClient``'s prober every ``KLOGS_RESOLVER_INTERVAL_S`` and
returns the fleet as it is now. The client diffs that against its
members (``shard.py:apply_membership``); a joiner gets no batch until
its Hello passes the pattern-set check.

Kinds (the ``--resolver`` grammar):

- ``static:HOST:PORT[,...]``: a fixed list, the same in effect as
  ``--remote``.
- ``file:/path``: one endpoint a line (``#`` comments and blank lines
  skipped), read again at each poll.
- ``dns:HOST:PORT``: HOST resolved again at each poll; every A/AAAA
  record becomes ``ip:PORT``.
- ``kube:NAMESPACE/NAME[:PORT]``: the named Endpoints object, through
  ``cluster/kube.py``'s apiserver client (its retry policy, token
  refresh and TLS). Without ``:PORT`` the subset's own port is used.

``resolve()`` returns the whole current list, a snapshot rather than a
delta, so a missed poll never puts the membership out of step. A
transient failure raises ``ResolverError``: the poller counts a
membership ``error`` event and keeps the fleet it has. The
``resolver.watch`` fault point wraps every poll.

No grpc or aiohttp is imported at module level: the CLI checks a spec
wherever it runs.
"""

import asyncio
from typing import Any, Callable

from klogs_tpu_torch.resilience import FAULTS

RESOLVER_KINDS = ("static", "file", "dns", "kube")
DEFAULT_RESOLVE_INTERVAL_S = 5.0


class ResolverError(RuntimeError):
    """A transient resolution failure (unreadable file, DNS timeout,
    apiserver weather): the poller keeps the current membership and
    retries next interval. Configuration errors (bad spec, bad
    kubeconfig) raise ValueError instead and fail startup loudly."""


def split_spec(spec: str) -> "tuple[str, str]":
    """``KIND:REST`` with a registered kind, or ValueError naming the
    bad spec — the CLI-side validation (grammar only; no I/O)."""
    kind, sep, rest = spec.partition(":")
    if not sep or kind not in RESOLVER_KINDS:
        raise ValueError(
            f"malformed --resolver spec {spec!r} "
            f"(want one of: {', '.join(k + ':...' for k in RESOLVER_KINDS)})")
    if not rest:
        raise ValueError(f"--resolver spec {spec!r} names no target")
    return kind, rest


class Resolver:
    """Base contract. Subclasses implement ``_resolve``; the public
    ``resolve`` wraps it in the ``resolver.watch`` fault point so an
    armed chaos script exercises the real keep-current-fleet path."""

    kind: str = "?"

    def describe(self) -> str:
        return self.kind

    async def resolve(self) -> "list[str]":
        if FAULTS.active:
            await FAULTS.fire("resolver.watch")
        return await self._resolve()

    async def _resolve(self) -> "list[str]":
        raise NotImplementedError

    async def aclose(self) -> None:  # noqa: B027 — default no-op
        """Release any discovery-side resources (the kube resolver's
        apiserver session). Owned and awaited by the sharded client's
        own aclose."""


class StaticResolver(Resolver):
    """A fixed list — membership never changes, the poll is a no-op
    diff. Exists so ``--resolver static:...`` behaves exactly like
    ``--remote`` and the plumbing stays testable end to end."""

    kind = "static"

    def __init__(self, targets: "list[str]") -> None:
        if not targets:
            raise ValueError("static resolver needs at least one endpoint")
        self._targets = list(targets)

    def describe(self) -> str:
        return f"static:{','.join(self._targets)}"

    async def _resolve(self) -> "list[str]":
        return list(self._targets)


class FileResolver(Resolver):
    """One endpoint per line; ``#`` starts a comment, blank lines are
    skipped. Re-read every poll (no inotify dependency — the poll
    cadence IS the watch). An unreadable file is transient: the fleet
    keeps flying on current membership while the operator fixes it."""

    kind = "file"

    def __init__(self, path: str) -> None:
        if not path:
            raise ValueError("file resolver needs a path")
        self._path = path

    def describe(self) -> str:
        return f"file:{self._path}"

    def _read(self) -> "list[str]":
        try:
            with open(self._path, encoding="utf-8") as f:
                raw = f.read()
        except OSError as e:
            raise ResolverError(
                f"cannot read resolver file {self._path}: {e}") from e
        targets: "list[str]" = []
        for line in raw.splitlines():
            entry = line.split("#", 1)[0].strip()
            if entry:
                targets.append(entry)
        return targets

    async def _resolve(self) -> "list[str]":
        # File I/O off the event loop: NFS/overlay mounts can stall.
        return await asyncio.to_thread(self._read)


class DnsResolver(Resolver):
    """Re-resolve one name to the full A/AAAA record set each poll —
    headless-Service/round-robin-DNS discovery. ``resolve_fn`` injects
    a fake for tests (the default is ``socket.getaddrinfo``)."""

    kind = "dns"

    def __init__(self, host: str, port: int,
                 resolve_fn: "Callable[[str], list[str]] | None" = None
                 ) -> None:
        if not host:
            raise ValueError("dns resolver needs HOST:PORT")
        if not 0 < port < 65536:
            raise ValueError(f"dns resolver: bad port {port!r}")
        self._host = host
        self._port = port
        self._resolve_fn = resolve_fn

    def describe(self) -> str:
        return f"dns:{self._host}:{self._port}"

    def _lookup(self) -> "list[str]":
        if self._resolve_fn is not None:
            addrs = self._resolve_fn(self._host)
        else:
            import socket

            try:
                infos = socket.getaddrinfo(self._host, self._port,
                                           type=socket.SOCK_STREAM)
            except OSError as e:
                raise ResolverError(
                    f"DNS resolution of {self._host} failed: {e}") from e
            addrs = [info[4][0] for info in infos]
        targets: "list[str]" = []
        for addr in addrs:
            host = f"[{addr}]" if ":" in addr else addr
            targets.append(f"{host}:{self._port}")
        return targets

    async def _resolve(self) -> "list[str]":
        # getaddrinfo blocks (glibc has no async path): worker thread.
        return await asyncio.to_thread(self._lookup)


class KubeEndpointsResolver(Resolver):
    """List a Kubernetes Endpoints object through the same apiserver
    client the pod-discovery path uses — shared RetryPolicy, one-shot
    401 token refresh, TLS from the kubeconfig. The backend is built
    lazily on the first poll (inside the running loop — the aiohttp
    session must bind there, and the collector may never poll if it
    exits first); ``backend_factory`` injects a fake for tests."""

    kind = "kube"

    def __init__(self, namespace: str, name: str,
                 port: "int | None" = None,
                 kubeconfig: "str | None" = None,
                 backend_factory: "Callable[[], Any] | None" = None
                 ) -> None:
        if not namespace or not name:
            raise ValueError(
                "kube resolver needs NAMESPACE/NAME[:PORT]")
        if port is not None and not 0 < port < 65536:
            raise ValueError(f"kube resolver: bad port {port!r}")
        self._namespace = namespace
        self._name = name
        self._port = port
        self._kubeconfig = kubeconfig
        self._backend_factory = backend_factory
        self._backend: Any = None

    def describe(self) -> str:
        suffix = f":{self._port}" if self._port is not None else ""
        return f"kube:{self._namespace}/{self._name}{suffix}"

    async def _ensure_backend(self) -> Any:
        if self._backend is None:
            if self._backend_factory is not None:
                self._backend = self._backend_factory()
            else:
                from klogs_tpu_torch.cluster.kube import KubeBackend
                from klogs_tpu_torch.cluster.kubeconfig import (
                    KubeconfigError,
                    load_creds,
                )

                try:
                    self._backend = KubeBackend(
                        load_creds(self._kubeconfig or ""))
                except KubeconfigError as e:
                    # Credentials may appear later (a projected token
                    # still mounting): transient, retried next poll.
                    raise ResolverError(str(e)) from e
        return self._backend

    async def _resolve(self) -> "list[str]":
        from klogs_tpu_torch.cluster.backend import ClusterError

        backend = await self._ensure_backend()
        try:
            doc = await backend.endpoint_addresses(
                self._namespace, self._name)
        except ClusterError as e:
            raise ResolverError(str(e)) from e
        targets: "list[str]" = []
        for ip, port in doc:
            use = self._port if self._port is not None else port
            if use is None:
                raise ResolverError(
                    f"Endpoints {self._namespace}/{self._name} "
                    f"advertises no port for {ip} and the --resolver "
                    "spec pins none")
            host = f"[{ip}]" if ":" in ip else ip
            targets.append(f"{host}:{use}")
        return targets

    async def aclose(self) -> None:
        backend, self._backend = self._backend, None
        if backend is not None:
            await backend.close()


def make_resolver(spec: str,
                  kubeconfig: "str | None" = None) -> Resolver:
    """Build a resolver from a ``--resolver`` spec. Grammar errors
    raise ValueError naming the spec (the pipeline wraps them in the
    CLI's friendly fatal path); I/O happens only at poll time."""
    kind, rest = split_spec(spec)
    if kind == "static":
        targets = [t.strip() for t in rest.split(",") if t.strip()]
        return StaticResolver(targets)
    if kind == "file":
        return FileResolver(rest)
    if kind == "dns":
        host, sep, port = rest.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(
                f"--resolver dns spec {spec!r}: want dns:HOST:PORT")
        return DnsResolver(host, int(port))
    # kube:NAMESPACE/NAME[:PORT]
    body, sep, port_s = rest.rpartition(":")
    port: "int | None" = None
    if sep and port_s.isdigit():
        port = int(port_s)
    else:
        body = rest
    namespace, sep, name = body.partition("/")
    if not sep or not namespace or not name:
        raise ValueError(
            f"--resolver kube spec {spec!r}: want "
            "kube:NAMESPACE/NAME[:PORT]")
    return KubeEndpointsResolver(namespace, name, port=port,
                                 kubeconfig=kubeconfig)
