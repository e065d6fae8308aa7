"""kubeconfig loading and TLS/auth resolution.

Counterpart of ``klogs_tpu/cluster/kubeconfig.py``. The subset klogs
needs (configClient and getCurrentNamespace, cmd/root.go:69-87 and
185-198 of the Go reference): resolve the file(s)
($KUBECONFIG — a path LIST merged with client-go semantics, explicit
--kubeconfig, else ~/.kube/config), pick the current context, and
produce everything required to talk to its cluster: server URL, CA
trust, client-cert/token auth, and the context's default namespace.

Supported auth: client certificates (inline *-data or file paths),
bearer tokens (inline or tokenFile), and exec-plugin credential helpers
(the client-go mode GKE/EKS/AKS default kubeconfigs use, reference gets
it via clientcmd at cmd/root.go:76): the helper command runs
non-interactively, its ExecCredential JSON yields a token or client
cert, and the result is cached until its expirationTimestamp.

When NO kubeconfig file exists, credentials fall back to the in-cluster
service account (rest.InClusterConfig analog) — the deployment mode of
a collector running as a pod. A kubeconfig that exists but is malformed
stays a hard error, as in client-go.
"""

import base64
import json
import os
import ssl
import subprocess
import tempfile
from dataclasses import dataclass
from datetime import datetime, timezone

import yaml


class KubeconfigError(RuntimeError):
    pass


class KubeconfigMissing(KubeconfigError):
    """No kubeconfig file exists at any candidate path — the only case
    that falls through to in-cluster credentials (a file that exists
    but is malformed stays a hard error, as in client-go)."""


@dataclass
class ClusterCreds:
    context_name: str
    namespace: str
    server: str  # https://host:port
    ssl_context: ssl.SSLContext
    token: str | None  # Authorization: Bearer
    # Re-resolves the bearer token on demand (exec-plugin helpers cache
    # until expirationTimestamp, so calling per request is cheap and a
    # --follow run outliving the token picks up the rotation, as
    # client-go does). None for static auth.
    token_provider: "callable | None" = None

    def current_token(self, force: bool = False) -> str | None:
        """The bearer token to use NOW. ``force`` bypasses the helper's
        expiry cache (after a 401 on a supposedly-fresh token)."""
        if self.token_provider is not None:
            try:
                tok = self.token_provider(force=force)
            except KubeconfigError as e:
                # Keep the last-known token (it may still work), but
                # surface the helper's real failure — a later 401 would
                # otherwise misdiagnose as "check your kubeconfig".
                from klogs_tpu_torch.ui import term

                term.warning("credential helper failed: %s", e)
                return self.token
            if tok:
                self.token = tok  # last-known-good for helper hiccups
                return tok
        return self.token


def kubeconfig_paths() -> list[str]:
    """$KUBECONFIG as a pathsep-separated list (client-go semantics),
    else the single default ~/.kube/config."""
    env = os.environ.get("KUBECONFIG")
    if env:
        return [p for p in env.split(os.pathsep) if p]
    return [os.path.join(os.path.expanduser("~"), ".kube", "config")]


def _merge_configs(paths: list[str]) -> dict:
    """client-go merge (clientcmd.Load): per-name map entries and the
    current-context scalar each come from the FIRST file that defines
    them; later files never override. Missing files are skipped; a file
    that exists but fails to parse is an error; all-missing is an
    error."""
    merged: dict = {"clusters": [], "contexts": [], "users": [],
                    "current-context": ""}
    seen: dict[str, set] = {"clusters": set(), "contexts": set(),
                            "users": set()}
    loaded_any = False
    for path in paths:
        try:
            with open(path) as f:
                cfg = yaml.safe_load(f)
        except FileNotFoundError:
            continue
        except OSError as e:
            raise KubeconfigError(f"cannot read kubeconfig {path}: {e}") from e
        except yaml.YAMLError as e:
            raise KubeconfigError(f"kubeconfig {path} is not valid YAML: {e}") from e
        if cfg is None:
            # Empty file (or only comments): client-go treats it as an
            # empty config and proceeds with the rest of the list.
            loaded_any = True
            continue
        if not isinstance(cfg, dict):
            raise KubeconfigError(f"kubeconfig {path} is not a mapping")
        loaded_any = True
        for section in ("clusters", "contexts", "users"):
            for item in cfg.get(section) or []:
                name = item.get("name")
                if name and name not in seen[section]:
                    seen[section].add(name)
                    merged[section].append(item)
        if not merged["current-context"] and cfg.get("current-context"):
            merged["current-context"] = cfg["current-context"]
    if not loaded_any:
        raise KubeconfigMissing(
            f"no kubeconfig found at {os.pathsep.join(paths)}"
        )
    return merged


def _write_temp(data: bytes, label: str) -> str:
    fd, tmp = tempfile.mkstemp(prefix=f"klogs-{label}-")
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return tmp


def _materialize(inline_b64: str | None, path: str | None, label: str,
                 tmps: list | None = None) -> str | None:
    """Inline base64 data wins over file paths (kubectl precedence);
    inline data lands in a private temp file for ssl's file-based API.
    Temp paths are appended to ``tmps`` so the caller can delete them
    once ssl has read them (the ssl file APIs read eagerly) — inline key
    material must not linger in /tmp."""
    if inline_b64:
        tmp = _write_temp(base64.b64decode(inline_b64), label)
        if tmps is not None:
            tmps.append(tmp)
        return tmp
    return path


# ExecCredential cache: helper runs are slow (they often hit a cloud
# metadata/token endpoint), so results are reused until their
# expirationTimestamp. Keyed by the full exec spec.
_EXEC_CACHE: dict[str, tuple[datetime | None, dict]] = {}

_EXEC_API_VERSIONS = (
    "client.authentication.k8s.io/v1",
    "client.authentication.k8s.io/v1beta1",
    "client.authentication.k8s.io/v1alpha1",
)

_EXEC_TIMEOUT_S = 60


def _parse_rfc3339(ts: str) -> datetime:
    """Expiry timestamp parsing, erring toward re-running the helper:
    tz-naive values are assumed UTC (a naive/aware comparison would
    TypeError), and an unparseable value counts as already expired
    (caching a broken-expiry credential forever would serve stale
    tokens)."""
    try:
        dt = datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except ValueError:
        return datetime.min.replace(tzinfo=timezone.utc)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


def exec_credential(spec: dict, force: bool = False) -> dict:
    """Run a kubeconfig exec credential helper and return the
    ExecCredential ``status`` dict (token and/or client cert). Results
    cache until status.expirationTimestamp (no expiry -> cached for the
    process lifetime, per client-go). ``force`` drops the cache entry
    first — used after the apiserver rejects a cached token (401) that
    the expiry said was still good. Never prompts: the helper runs with
    interactive=false."""
    key = json.dumps(spec, sort_keys=True, default=str)
    if force:
        _EXEC_CACHE.pop(key, None)
    hit = _EXEC_CACHE.get(key)
    if hit is not None:
        expiry, status = hit
        if expiry is None or datetime.now(timezone.utc) < expiry:
            return status

    command = spec.get("command")
    if not command:
        raise KubeconfigError("kubeconfig exec entry has no command")
    api_version = spec.get("apiVersion") or _EXEC_API_VERSIONS[1]
    if api_version not in _EXEC_API_VERSIONS:
        raise KubeconfigError(
            f"unsupported exec plugin apiVersion {api_version!r}")
    argv = [command] + list(spec.get("args") or [])
    env = dict(os.environ)
    for pair in spec.get("env") or []:
        if pair.get("name"):
            env[pair["name"]] = pair.get("value", "")
    env["KUBERNETES_EXEC_INFO"] = json.dumps({
        "apiVersion": api_version,
        "kind": "ExecCredential",
        "spec": {"interactive": False},
    })
    try:
        res = subprocess.run(argv, capture_output=True, text=True, env=env,
                             timeout=_EXEC_TIMEOUT_S)
    except FileNotFoundError as e:
        raise KubeconfigError(
            f"exec credential helper {command!r} not found: {e}") from e
    except subprocess.TimeoutExpired as e:
        raise KubeconfigError(
            f"exec credential helper {command!r} timed out") from e
    if res.returncode != 0:
        tail = (res.stderr or "").strip().splitlines()[-3:]
        raise KubeconfigError(
            f"exec credential helper {command!r} failed "
            f"(rc={res.returncode}): {' '.join(tail)}")
    try:
        cred = json.loads(res.stdout)
    except ValueError as e:
        raise KubeconfigError(
            f"exec credential helper {command!r} printed invalid JSON") from e
    status = cred.get("status") or {}
    if not (status.get("token")
            or (status.get("clientCertificateData")
                and status.get("clientKeyData"))):
        raise KubeconfigError(
            f"exec credential helper {command!r} returned neither a token "
            "nor a client certificate")
    expiry = (_parse_rfc3339(status["expirationTimestamp"])
              if status.get("expirationTimestamp") else None)
    _EXEC_CACHE[key] = (expiry, status)
    return status


# Kubelet-mounted service-account directory (rest.InClusterConfig).
SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def in_cluster_creds() -> "ClusterCreds | None":
    """client-go rest.InClusterConfig analog: when running inside a pod,
    the kubelet mounts a service-account token + CA and the apiserver
    address is in the environment. Returns None when not in a pod.

    The token is re-read from the mounted file on every refresh: bound
    service-account tokens rotate (~1h) and the kubelet updates the
    file, so a long --follow survives rotation (client-go re-reads
    periodically for the same reason)."""
    # client-go ErrNotInCluster semantics: BOTH env vars must be
    # non-empty (a set-but-empty value means "not in a pod", never a
    # default port).
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT")
    token_path = os.path.join(SA_DIR, "token")
    ca_path = os.path.join(SA_DIR, "ca.crt")
    if not host or not port or not os.path.exists(token_path):
        return None
    if ":" in host and not host.startswith("["):
        host = f"[{host}]"  # IPv6 (client-go: net.JoinHostPort)
    try:
        ssl_ctx = (ssl.create_default_context(cafile=ca_path)
                   if os.path.exists(ca_path)
                   else ssl.create_default_context())
    except ssl.SSLError as e:
        # Keep the module's error contract: a corrupt mounted CA must
        # surface as the friendly fatal, not a raw traceback.
        raise KubeconfigError(
            f"in-cluster CA bundle {ca_path} is unusable: {e}") from e
    try:
        with open(os.path.join(SA_DIR, "namespace")) as f:
            namespace = f.read().strip() or "default"
    except OSError:
        namespace = "default"

    def provider(force: bool = False) -> "str | None":
        try:
            with open(token_path) as f:
                return f.read().strip() or None
        except OSError:
            return None

    return ClusterCreds(
        context_name="in-cluster",
        namespace=namespace,
        server=f"https://{host}:{port}",
        ssl_context=ssl_ctx,
        token=provider(),
        token_provider=provider,
    )


def load_creds(kubeconfig: str = "") -> ClusterCreds:
    if not kubeconfig:
        # client-go fallback order: kubeconfig file(s) first, then the
        # in-cluster service account when no file exists (the common
        # case for a collector running as a pod).
        try:
            return _file_creds(kubeconfig_paths())
        except KubeconfigMissing:
            creds = in_cluster_creds()
            if creds is not None:
                return creds
            raise
    return _file_creds([kubeconfig])


def _file_creds(paths: list[str]) -> ClusterCreds:
    cfg = _merge_configs(paths)
    path_desc = os.pathsep.join(paths)

    ctx_name = cfg.get("current-context") or ""
    contexts = {c["name"]: c.get("context", {}) for c in cfg.get("contexts", [])}
    if not ctx_name or ctx_name not in contexts:
        raise KubeconfigError(
            f"kubeconfig {path_desc} has no usable current-context ({ctx_name!r})"
        )
    ctx = contexts[ctx_name]
    namespace = ctx.get("namespace") or "default"

    clusters = {c["name"]: c.get("cluster", {}) for c in cfg.get("clusters", [])}
    users = {u["name"]: u.get("user", {}) for u in cfg.get("users", [])}
    cluster = clusters.get(ctx.get("cluster", ""))
    if cluster is None:
        raise KubeconfigError(f"context {ctx_name!r} names unknown cluster")
    user = users.get(ctx.get("user", ""), {})

    server = cluster.get("server")
    if not server:
        raise KubeconfigError(f"cluster for context {ctx_name!r} has no server")

    tmps: list[str] = []
    try:
        if cluster.get("insecure-skip-tls-verify"):
            ssl_ctx = ssl._create_unverified_context()
        else:
            ca = _materialize(cluster.get("certificate-authority-data"),
                              cluster.get("certificate-authority"), "ca", tmps)
            ssl_ctx = ssl.create_default_context(cafile=ca)

        cert = _materialize(user.get("client-certificate-data"),
                            user.get("client-certificate"), "cert", tmps)
        key = _materialize(user.get("client-key-data"),
                           user.get("client-key"), "key", tmps)
        if cert and key:
            ssl_ctx.load_cert_chain(cert, key)
    finally:
        for p in tmps:
            try:
                os.unlink(p)
            except OSError:
                pass

    token = user.get("token")
    token_provider = None
    if not token and user.get("tokenFile"):
        with open(user["tokenFile"]) as f:
            token = f.read().strip()
    if not token and not (cert and key) and user.get("exec"):
        status = exec_credential(user["exec"])
        token = status.get("token")
        if not token:
            # ExecCredential cert/key are PEM text, not base64.
            ec = _write_temp(status["clientCertificateData"].encode(),
                             "exec-cert")
            ek = _write_temp(status["clientKeyData"].encode(), "exec-key")
            try:
                ssl_ctx.load_cert_chain(ec, ek)
            finally:
                # load_cert_chain reads eagerly; the key material must
                # not linger in /tmp.
                for p in (ec, ek):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
        else:
            # Token-mode helper: re-run (cache honors expiry) so long
            # follows survive token rotation.
            spec = user["exec"]
            token_provider = (
                lambda force=False: exec_credential(spec, force=force)
                .get("token"))

    return ClusterCreds(
        context_name=ctx_name,
        namespace=namespace,
        server=server.rstrip("/"),
        ssl_context=ssl_ctx,
        token=token,
        token_provider=token_provider,
    )
