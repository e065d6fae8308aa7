"""Real Kubernetes backend over the apiserver REST API (aiohttp).

Counterpart of ``klogs_tpu/cluster/kube.py``. The data path mirrors
the Go reference's client-go use: namespace Get/List, pod List with a
label selector, and the pod log GET, streamed in chunks, with the
follow/since/tail/previous/timestamps/sinceTime queries; and the
Endpoints GET of the filterd fleet's kube resolver. The aiohttp
connector limit plays the role of the reference's rest config Burst =
100.

Control-plane GETs retry transient failures (5xx, dropped connections,
timeouts, injected faults) under ``DEFAULT_RETRY`` and end in a one-line
ClusterError; a 401 with an exec-plugin token refreshes the token once,
on a GET and on a log request alike. The fault points ``kube.list_pods``
(inside the GET's retry loop) and ``kube.log_stream`` (a log request,
which the fan-out's reconnect policy retries) fire here; with a
registry bound (``bind_registry``) the GET's retries count into
``klogs_retry_attempts_total{site="kube"}``.
"""

import asyncio
from typing import AsyncIterator

import aiohttp

from klogs_tpu_torch.cluster.backend import (
    ClusterBackend,
    ClusterError,
    LogStream,
    StreamError,
)
from klogs_tpu_torch.cluster.kubeconfig import (
    ClusterCreds,
    KubeconfigError,
    load_creds,
)
from klogs_tpu_torch.cluster.types import ContainerInfo, LogOptions, PodInfo
from klogs_tpu_torch.resilience.faults import FAULTS, InjectedFault
from klogs_tpu_torch.resilience.policy import RetryPolicy
from klogs_tpu_torch.ui import term

BURST = 100

# A short budget: these GETs gate interactive startup, so the worst-case
# added latency stays under ~2 s.
DEFAULT_RETRY = RetryPolicy(max_attempts=4, base_s=0.25, max_s=2.0,
                            jitter=0.1)


class _TransientHTTPError(Exception):
    """A 5xx the retry loop may still fix; never escapes _get_json."""


class KubeLogStream(LogStream):
    """One log response as a chunk stream. Chunks are whatever the
    connection delivers (``iter_any``): their boundaries need not align
    with lines. ``close`` releases the connection, which ends a pending
    read."""

    def __init__(self, resp: aiohttp.ClientResponse):
        self._resp = resp

    def __aiter__(self) -> AsyncIterator[bytes]:
        return self._chunks()

    async def _chunks(self) -> AsyncIterator[bytes]:
        try:
            async for chunk in self._resp.content.iter_any():
                yield chunk
        except (aiohttp.ClientError, asyncio.TimeoutError) as e:
            # The fan-out owns the reconnect policy either way.
            raise StreamError(
                f"log stream failed: {str(e) or 'read timed out'}") from e

    async def close(self) -> None:
        self._resp.close()


class KubeBackend(ClusterBackend):
    def __init__(self, creds: ClusterCreds,
                 retry: "RetryPolicy | None" = None, registry=None):
        self._creds = creds
        self._retry = retry if retry is not None else DEFAULT_RETRY
        self._retries_metric = None
        self.bind_registry(registry)
        # Auth is resolved per request, not baked into the session:
        # exec-plugin tokens rotate, and a follow run may outlive one.
        self._session = aiohttp.ClientSession(
            base_url=creds.server,
            connector=aiohttp.TCPConnector(limit=BURST,
                                           ssl=creds.ssl_context),
            # HTTP(S)_PROXY/NO_PROXY, as client-go honors them.
            trust_env=True,
        )

    async def _auth_headers(self, force_refresh: bool = False) -> dict:
        if self._creds.token_provider is None:
            token = self._creds.token
        else:
            # The exec helper is a blocking subprocess: off the loop.
            token = await asyncio.to_thread(
                self._creds.current_token, force_refresh)
        return {"Authorization": f"Bearer {token}"} if token else {}

    @classmethod
    def from_kubeconfig(cls, kubeconfig: str) -> "KubeBackend":
        try:
            return cls(load_creds(kubeconfig))
        except KubeconfigError as e:
            term.fatal("%s", e)
            raise AssertionError("unreachable")

    def current_context(self) -> tuple[str, str]:
        return self._creds.context_name, self._creds.namespace

    def bind_registry(self, registry) -> None:
        """Point the GET retry counter at a run's registry (the backend
        exists before the run's registry does)."""
        if registry is not None:
            self._retries_metric = registry.family(
                "klogs_retry_attempts_total").labels(site="kube")

    async def _get_json(self, path: str, params: dict | None = None,
                        fault_point: "str | None" = None):
        """Control-plane GET: None on 404, the JSON body on success.
        Transient failures retry under the policy and end in a
        ClusterError with one human line; the one-shot 401 token refresh
        spends no retry budget."""
        attempt = 0
        refreshed = False  # the one forced token refresh happened
        force = False      # force the provider on the next header fetch
        while True:
            try:
                if fault_point is not None and FAULTS.active:
                    await FAULTS.fire(fault_point)
                async with self._session.get(
                    path, params=params or {},
                    headers=await self._auth_headers(force_refresh=force),
                ) as resp:
                    force = False
                    if resp.status == 404:
                        return None
                    if (resp.status == 401 and not refreshed
                            and self._creds.token_provider is not None):
                        refreshed = True
                        force = True
                        continue
                    if resp.status in (401, 403):
                        word = ("Unauthorized" if resp.status == 401
                                else "Forbidden")
                        raise ClusterError(
                            f"{word} (HTTP {resp.status}) from "
                            f"{self._creds.server}{path} — check your "
                            f"kubeconfig credentials (context "
                            f"{self._creds.context_name!r})")
                    if resp.status >= 500:
                        body = (await resp.text())[:200]
                        raise _TransientHTTPError(
                            f"apiserver error HTTP {resp.status} on "
                            f"{path}: {body}")
                    if resp.status >= 400:
                        body = (await resp.text())[:200]
                        raise ClusterError(
                            f"apiserver error HTTP {resp.status} on {path}: "
                            f"{body}")
                    return await resp.json()
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    InjectedFault, _TransientHTTPError) as e:
                if not self._retry.retries_left(attempt):
                    if isinstance(e, _TransientHTTPError):
                        raise ClusterError(
                            f"{e} (after {attempt + 1} attempts)") from e
                    raise ClusterError(
                        f"cannot reach apiserver {self._creds.server}: "
                        f"{str(e) or 'request timed out'} "
                        f"(after {attempt + 1} attempts)") from e
                if self._retries_metric is not None:
                    self._retries_metric.inc()
                await self._retry.sleep(attempt)
                attempt += 1

    async def namespace_exists(self, namespace: str) -> bool:
        return await self._get_json(
            f"/api/v1/namespaces/{namespace}") is not None

    async def list_namespaces(self) -> list[str]:
        data = await self._get_json("/api/v1/namespaces")
        return [item["metadata"]["name"] for item in data.get("items", [])]

    async def list_pods(self, namespace: str,
                        label_selector: str | None = None) -> list[PodInfo]:
        params = {"labelSelector": label_selector} if label_selector else None
        data = await self._get_json(f"/api/v1/namespaces/{namespace}/pods",
                                    params, fault_point="kube.list_pods")
        if data is None:
            return []
        return [_pod_info(item, namespace) for item in data.get("items", [])]

    async def endpoint_addresses(
            self, namespace: str,
            name: str) -> "list[tuple[str, int | None]]":
        """The (ip, port) pairs of the named Endpoints object: the kube
        resolver's data (service/resolver.py, whose poll fires
        ``resolver.watch``). A missing object is an empty list (the
        Service may not exist yet in a rollout; the client keeps its
        fleet on an empty one). A subset with one port gives it to its
        addresses; with several the port is None and the ``--resolver``
        spec must pin one."""
        data = await self._get_json(
            f"/api/v1/namespaces/{namespace}/endpoints/{name}")
        if data is None:
            return []
        out: "list[tuple[str, int | None]]" = []
        for subset in data.get("subsets") or []:
            ports = [p.get("port") for p in subset.get("ports") or []
                     if isinstance(p.get("port"), int)]
            port = ports[0] if len(ports) == 1 else None
            for addr in subset.get("addresses") or []:
                ip = addr.get("ip")
                if ip:
                    out.append((str(ip), port))
        return out

    async def open_log_stream(self, namespace: str, pod: str,
                              opts: LogOptions) -> LogStream:
        params: dict = {"container": opts.container}
        if opts.follow:
            params["follow"] = "true"
        if opts.since_seconds is not None:
            params["sinceSeconds"] = str(opts.since_seconds)
        if opts.tail_lines is not None:
            params["tailLines"] = str(opts.tail_lines)
        if opts.previous:
            params["previous"] = "true"
        if opts.timestamps:
            params["timestamps"] = "true"
        if opts.since_time is not None:
            params["sinceTime"] = opts.since_time
        try:
            if FAULTS.active:
                await FAULTS.fire("kube.log_stream")
            resp = None
            for attempt in (0, 1):
                resp = await self._session.get(
                    f"/api/v1/namespaces/{namespace}/pods/{pod}/log",
                    params=params,
                    headers=await self._auth_headers(
                        force_refresh=attempt > 0),
                    timeout=aiohttp.ClientTimeout(total=None, sock_connect=30),
                )
                if (resp.status == 401 and attempt == 0
                        and self._creds.token_provider is not None):
                    # A rotated token: refresh once, without spending the
                    # reconnect budget.
                    resp.close()
                    continue
                break
            if resp.status != 200:
                body = (await resp.text())[:300]
                resp.close()
                raise StreamError(
                    f"GET log for {pod}/{opts.container}: "
                    f"HTTP {resp.status}: {body}")
        except (aiohttp.ClientError, asyncio.TimeoutError,
                InjectedFault) as e:
            raise StreamError(
                f"open log stream {pod}/{opts.container}: "
                f"{str(e) or 'connect timed out'}") from e
        return KubeLogStream(resp)

    async def close(self) -> None:
        await self._session.close()


def _pod_info(item: dict, namespace: str) -> PodInfo:
    meta = item.get("metadata", {})
    spec = item.get("spec", {})
    status = item.get("status", {})
    ready = any(c.get("type") == "Ready" and c.get("status") == "True"
                for c in status.get("conditions", []))
    return PodInfo(
        name=meta.get("name", ""),
        namespace=namespace,
        labels=meta.get("labels", {}) or {},
        ready=ready,
        containers=[ContainerInfo(c["name"])
                    for c in spec.get("containers", [])],
        init_containers=[ContainerInfo(c["name"], init=True)
                         for c in spec.get("initContainers", [])],
    )
