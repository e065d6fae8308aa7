"""The port's KubeBackend and kubeconfig loader against the JAX
package's, on the same inputs: both backends talk to one local aiohttp
fake apiserver (which records every request), and both loaders read the
same kubeconfig files."""

import asyncio
import base64
import os
import ssl
import sys

import pytest
import yaml
from aiohttp import web

from klogs_tpu import cli as jax_cli
from klogs_tpu.cluster import kube as jax_kube
from klogs_tpu.cluster import kubeconfig as jax_kc
from klogs_tpu.cluster.backend import ClusterError as JaxClusterError
from klogs_tpu.cluster.types import LogOptions as JaxLogOptions
from klogs_tpu.resilience import RetryPolicy as JaxRetryPolicy
from klogs_tpu_torch import cli
from klogs_tpu_torch.cluster import kube, kubeconfig
from klogs_tpu_torch.cluster.backend import ClusterError
from klogs_tpu_torch.cluster.types import LogOptions
from klogs_tpu_torch.resilience.policy import RetryPolicy

TOKEN = "test-token-123"

PODS = {
    "api-1": {"labels": {"app": "api"}, "ready": True,
              "containers": ["srv", "sidecar"], "init": ["setup"]},
    "api-2": {"labels": {"app": "api"}, "ready": False,
              "containers": ["srv"], "init": []},
    "db-1": {"labels": {"app": "db"}, "ready": True,
             "containers": ["pg"], "init": []},
}

SIDES = {
    "jax": dict(kube=jax_kube, kc=jax_kc, opts=JaxLogOptions,
                err=JaxClusterError, retry=JaxRetryPolicy),
    "torch": dict(kube=kube, kc=kubeconfig, opts=LogOptions,
                  err=ClusterError, retry=RetryPolicy),
}


def _pod_item(name, meta):
    return {
        "metadata": {"name": name, "labels": meta["labels"]},
        "spec": {"containers": [{"name": c} for c in meta["containers"]],
                 "initContainers": [{"name": c} for c in meta["init"]]},
        "status": {"conditions": [
            {"type": "Ready", "status": "True" if meta["ready"] else "False"}]},
    }


def make_app(requests: list, fail_5xx: int = 0):
    """The apiserver: ``requests`` gets (path, query, auth) of each
    request; the first ``fail_5xx`` requests answer 503."""
    app = web.Application()
    left = [fail_5xx]

    @web.middleware
    async def record(request, handler):
        requests.append((request.path, dict(sorted(request.query.items())),
                         request.headers.get("Authorization")))
        if left[0] > 0:
            left[0] -= 1
            return web.Response(status=503, text="overloaded")
        if request.headers.get("Authorization") != f"Bearer {TOKEN}":
            return web.Response(status=401, text="unauthorized")
        return await handler(request)

    app.middlewares.append(record)

    async def namespaces(request):
        return web.json_response({"items": [
            {"metadata": {"name": n}} for n in ("default", "kube-system")]})

    async def namespace(request):
        ns = request.match_info["ns"]
        if ns in ("default", "kube-system"):
            return web.json_response({"metadata": {"name": ns}})
        return web.Response(status=404)

    async def pods(request):
        sel = request.query.get("labelSelector")
        items = []
        for name, meta in PODS.items():
            if sel:
                k, _, v = sel.partition("=")
                if meta["labels"].get(k) != v:
                    continue
            items.append(_pod_item(name, meta))
        return web.json_response({"items": items})

    async def log(request):
        pod = request.match_info["pod"]
        if pod not in PODS:
            return web.Response(status=404, text="pod not found")
        q = request.query
        container = q.get("container", "")
        lines = [f"{pod}/{container} line {i}\n".encode() for i in range(10)]
        if q.get("previous") == "true":
            lines = [f"{pod}/{container} prev {i}\n".encode()
                     for i in range(2)]
        if q.get("sinceTime"):
            lines = [b"since-time-applied\n"]
        if q.get("timestamps") == "true":
            lines = [b"2026-07-31T00:00:00.000000000Z " + ln for ln in lines]
        if q.get("tailLines") is not None:
            lines = lines[-int(q["tailLines"]):]
        resp = web.StreamResponse()
        await resp.prepare(request)
        data = b"".join(lines)
        for i in range(0, len(data), 7):  # chunks cut across lines
            await resp.write(data[i:i + 7])
        if q.get("follow") == "true":
            for i in range(3):
                await resp.write(f"{pod}/{container} follow {i}\n".encode())
        await resp.write_eof()
        return resp

    app.router.add_get("/api/v1/namespaces", namespaces)
    app.router.add_get("/api/v1/namespaces/{ns}", namespace)
    app.router.add_get("/api/v1/namespaces/{ns}/pods", pods)
    app.router.add_get("/api/v1/namespaces/{ns}/pods/{pod}/log", log)
    return app


def write_kubeconfig(path, server, token=TOKEN, namespace="kube-system"):
    cfg = {
        "current-context": "testctx",
        "contexts": [{"name": "testctx", "context": {
            "cluster": "c1", "user": "u1", "namespace": namespace}}],
        "clusters": [{"name": "c1", "cluster": {
            "server": server, "insecure-skip-tls-verify": True}}],
        "users": [{"name": "u1", "user": {"token": token}}],
    }
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


async def on_server(fn, fail_5xx: int = 0):
    """``fn(server_url, requests)`` against a fresh fake apiserver."""
    requests: list = []
    runner = web.AppRunner(make_app(requests, fail_5xx))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    try:
        return await fn(f"http://127.0.0.1:{port}", requests)
    finally:
        await runner.cleanup()


async def _read(stream) -> bytes:
    data = b""
    async for chunk in stream:
        data += chunk
    await stream.close()
    return data


def _pod_key(p):
    return (p.name, p.namespace, sorted(p.labels.items()), p.ready,
            [(c.name, c.init) for c in p.containers],
            [(c.name, c.init) for c in p.init_containers])


LOG_CASES = [
    dict(container="srv", tail_lines=3),
    dict(container="pg", follow=True),
    dict(container="srv", previous=True),
    dict(container="srv", timestamps=True, tail_lines=1),
    dict(container="srv", since_time="2026-07-31T00:00:00Z"),
    dict(container="srv", since_seconds=30, follow=True, timestamps=True),
]


async def _exchange(side: str, tmp_path):
    s = SIDES[side]

    async def fn(server, requests):
        path = write_kubeconfig(tmp_path / f"kc-{side}", server)
        b = s["kube"].KubeBackend.from_kubeconfig(path)
        try:
            out = [b.current_context(), await b.list_namespaces(),
                   await b.namespace_exists("default"),
                   await b.namespace_exists("nope"),
                   [_pod_key(p) for p in await b.list_pods("default")],
                   [_pod_key(p) for p in await b.list_pods(
                       "default", label_selector="app=db")]]
            for kw in LOG_CASES:
                pod = "db-1" if kw["container"] == "pg" else "api-1"
                out.append(await _read(await b.open_log_stream(
                    "default", pod, s["opts"](**kw))))
        finally:
            await b.close()
        return out, requests

    return await on_server(fn)


def test_backend_requests_and_answers_equal_jax(tmp_path):
    got, got_req = asyncio.run(_exchange("torch", tmp_path))
    exp, exp_req = asyncio.run(_exchange("jax", tmp_path))
    assert got == exp
    assert got_req == exp_req
    assert all(auth == f"Bearer {TOKEN}" for _, _, auth in got_req)
    assert got[-1].endswith(b"api-1/srv follow 2\n")
    assert got[-1].startswith(b"2026-07-31T00:00:00.000000000Z api-1/srv")
    log_queries = [q for p, q, _ in got_req if p.endswith("/log")]
    assert log_queries[-1] == {"container": "srv", "follow": "true",
                               "sinceSeconds": "30", "timestamps": "true"}


def _rotating_creds(side: str, server: str):
    """Creds whose token provider yields a stale token until forced."""
    calls = []

    def provider(force=False):
        calls.append(force)
        return TOKEN if force or len(calls) > 2 else "stale-token"

    creds = SIDES[side]["kc"].ClusterCreds(
        context_name="testctx", namespace="kube-system", server=server,
        ssl_context=ssl.create_default_context(), token="stale-token",
        token_provider=provider)
    return creds, calls


@pytest.mark.parametrize("what", ["get", "log"])
def test_401_refreshes_the_token_once_as_jax_does(what):
    async def run_side(side):
        async def fn(server, requests):
            creds, calls = _rotating_creds(side, server)
            b = SIDES[side]["kube"].KubeBackend(creds)
            try:
                if what == "get":
                    got = await b.list_namespaces()
                else:
                    got = await _read(await b.open_log_stream(
                        "default", "api-1",
                        SIDES[side]["opts"](container="srv", tail_lines=2)))
            finally:
                await b.close()
            return got, calls, [auth for _, _, auth in requests]

        return await on_server(fn)

    got = asyncio.run(run_side("torch"))
    assert got == asyncio.run(run_side("jax"))
    assert got[1] == [False, True]
    assert got[2] == ["Bearer stale-token", f"Bearer {TOKEN}"]


ERROR_CASES = ["static_401", "log_404", "persistent_5xx", "unreachable"]


@pytest.mark.parametrize("case", ERROR_CASES)
def test_friendly_errors_equal_jax(tmp_path, case):
    async def run_side(side):
        s = SIDES[side]

        async def fn(server, requests):
            if case == "unreachable":
                server = "http://127.0.0.1:9"
            path = write_kubeconfig(
                tmp_path / f"kc-{side}", server,
                token="wrong" if case == "static_401" else TOKEN)
            creds = s["kc"].load_creds(path)
            b = s["kube"].KubeBackend(creds, retry=s["retry"](
                max_attempts=3, base_s=0.0, jitter=0.0))
            try:
                if case == "log_404":
                    await b.open_log_stream("default", "ghost",
                                            s["opts"](container="x"))
                else:
                    await b.list_pods("default")
            except s["err"] as e:
                # Each side has a server of its own: its URL differs.
                return (type(e).__name__, str(e).replace(server, "<server>"),
                        len(requests))
            finally:
                await b.close()
            return None

        return await on_server(fn, fail_5xx=99 if case == "persistent_5xx"
                               else 0)

    got = asyncio.run(run_side("torch"))
    assert got is not None
    assert got == asyncio.run(run_side("jax"))
    assert "\n" not in got[1]


def test_cli_main_one_line_error_for_a_bad_token(tmp_path, capsys):
    """``cli.main`` over ``--cluster kube`` with a rejected token: exit 1
    and JAX's one line (the apiserver runs in a thread of its own, as
    ``cli.main`` starts its own event loop)."""
    import threading

    started, done, port = threading.Event(), threading.Event(), []

    def serve():
        async def up():
            runner = web.AppRunner(make_app([]))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port.append(site._server.sockets[0].getsockname()[1])
            started.set()
            while not done.is_set():
                await asyncio.sleep(0.02)
            await runner.cleanup()

        asyncio.run(up())

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    assert started.wait(10)
    try:
        path = write_kubeconfig(tmp_path / "kc",
                                f"http://127.0.0.1:{port[0]}", token="wrong")
        argv = ["--kubeconfig", path, "-a", "-p", str(tmp_path / "logs")]
        capsys.readouterr()
        assert cli.main(argv, device="cpu") == 1
        got = capsys.readouterr().out
        assert jax_cli.main(argv) == 1
        exp = capsys.readouterr().out
    finally:
        done.set()
        t.join(timeout=10)
    assert not t.is_alive()
    err = lambda text: [ln for ln in text.splitlines() if "ERROR" in ln]
    assert err(got) == err(exp)
    assert "Unauthorized (HTTP 401)" in err(got)[0]
    assert "Traceback" not in got


# ---- kubeconfig loading -------------------------------------------------

def _ca_pem() -> bytes:
    pytest.importorskip("cryptography")
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(x509.NameOID.COMMON_NAME, "t")])
    now = datetime.datetime(2024, 1, 1)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=3650))
            .sign(key, hashes.SHA256()))
    return cert.public_bytes(serialization.Encoding.PEM)


def _exec_helper(tmp_path, status: dict):
    """A stub exec credential plugin that counts its runs."""
    counter = tmp_path / "calls"
    counter.write_text("0")
    script = tmp_path / "helper.py"
    script.write_text(
        "import json, pathlib\n"
        f"c = pathlib.Path({str(counter)!r})\n"
        "c.write_text(str(int(c.read_text()) + 1))\n"
        "print(json.dumps({'apiVersion': "
        "'client.authentication.k8s.io/v1beta1', 'kind': 'ExecCredential',"
        f" 'status': {status!r}}}))\n")
    return script, counter


def _cfg(user: dict, cluster: dict | None = None, namespace=None) -> dict:
    ctx = {"cluster": "cl", "user": "u"}
    if namespace:
        ctx["namespace"] = namespace
    return {"current-context": "c",
            "contexts": [{"name": "c", "context": ctx}],
            "clusters": [{"name": "cl", "cluster": cluster or {
                "server": "https://example:6443/",
                "insecure-skip-tls-verify": True}}],
            "users": [{"name": "u", "user": user}]}


def _setup_case(case: str, tmp_path, monkeypatch) -> str:
    """Files and environment for one kubeconfig case; returns the
    --kubeconfig argument ("" = the default search)."""
    d = tmp_path
    if case == "token":
        (d / "kc").write_text(yaml.safe_dump(_cfg({"token": "t"},
                                                  namespace="ns1")))
        return str(d / "kc")
    if case == "token_file":
        (d / "tok").write_text("file-token\n")
        (d / "kc").write_text(yaml.safe_dump(_cfg({"tokenFile":
                                                   str(d / "tok")})))
        return str(d / "kc")
    if case == "inline_ca":
        (d / "kc").write_text(yaml.safe_dump(_cfg({"token": "t"}, {
            "server": "https://example:6443",
            "certificate-authority-data":
                base64.b64encode(_ca_pem()).decode()})))
        return str(d / "kc")
    if case == "multipath_merge":
        (d / "one").write_text(yaml.safe_dump({
            "current-context": "ctx1",
            "contexts": [{"name": "ctx1", "context": {
                "cluster": "cl", "user": "u", "namespace": "ns-one"}}]}))
        (d / "empty").write_text("# only a comment\n")
        (d / "two").write_text(yaml.safe_dump({
            "current-context": "ctx2",
            "contexts": [
                {"name": "ctx1", "context": {"cluster": "other", "user": "u",
                                             "namespace": "bad"}},
                {"name": "ctx2", "context": {"cluster": "cl", "user": "u"}}],
            "clusters": [{"name": "cl", "cluster": {
                "server": "https://merged:6443",
                "insecure-skip-tls-verify": True}}],
            "users": [{"name": "u", "user": {"token": "merged"}}]}))
        monkeypatch.setenv("KUBECONFIG", os.pathsep.join(
            str(d / n) for n in ("missing", "one", "empty", "two")))
        return ""
    if case in ("exec_cached", "exec_expired"):
        expiry = ("2099-01-01T00:00:00Z" if case == "exec_cached"
                  else "2001-01-01T00:00:00Z")
        script, _ = _exec_helper(d, {"token": "exec-tok",
                                     "expirationTimestamp": expiry})
        (d / "kc").write_text(yaml.safe_dump(_cfg({"exec": {
            "apiVersion": "client.authentication.k8s.io/v1beta1",
            "command": sys.executable, "args": [str(script)]}})))
        return str(d / "kc")
    if case == "in_cluster":
        sa = d / "sa"
        sa.mkdir()
        (sa / "token").write_text("sa-token\n")
        (sa / "namespace").write_text("prod\n")
        for mod in (jax_kc, kubeconfig):
            monkeypatch.setattr(mod, "SA_DIR", str(sa))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "fd00::1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "443")
        monkeypatch.setenv("KUBECONFIG", str(d / "nope"))
        return ""
    raise AssertionError(case)


KC_CASES = ["token", "token_file", "inline_ca", "multipath_merge",
            "exec_cached", "exec_expired", "in_cluster"]


@pytest.mark.parametrize("case", KC_CASES)
def test_load_creds_equals_jax(tmp_path, monkeypatch, case):
    monkeypatch.setattr(jax_kc, "_EXEC_CACHE", {})
    monkeypatch.setattr(kubeconfig, "_EXEC_CACHE", {})
    arg = _setup_case(case, tmp_path, monkeypatch)
    fields = {}
    for side in SIDES:
        kc = SIDES[side]["kc"]
        if case.startswith("exec"):
            (tmp_path / "calls").write_text("0")
        runs = [kc.load_creds(arg), kc.load_creds(arg)]
        fields[side] = [(c.context_name, c.namespace, c.server, c.token,
                         c.token_provider is not None, c.current_token())
                        for c in runs]
        if case.startswith("exec"):
            fields[side].append((tmp_path / "calls").read_text())
    assert fields["torch"] == fields["jax"]
    if case == "exec_cached":
        assert fields["torch"][-1] == "1"  # one helper run a side
    if case == "exec_expired":
        assert fields["torch"][-1] == "4"  # every load and token re-runs


@pytest.mark.parametrize("case", ["missing", "no_context", "bad_yaml",
                                  "not_a_mapping", "no_server"])
def test_kubeconfig_errors_equal_jax(tmp_path, case):
    p = tmp_path / "kc"
    if case == "no_context":
        p.write_text("clusters: []\n")
    elif case == "bad_yaml":
        p.write_text("{not yaml: [")
    elif case == "not_a_mapping":
        p.write_text("- a\n- b\n")
    elif case == "no_server":
        cfg = _cfg({"token": "t"})
        cfg["clusters"][0]["cluster"] = {"insecure-skip-tls-verify": True}
        p.write_text(yaml.safe_dump(cfg))
    msgs = {}
    for side in SIDES:
        kc = SIDES[side]["kc"]
        with pytest.raises(kc.KubeconfigError) as ei:
            kc.load_creds(str(p))
        msgs[side] = (type(ei.value).__name__, str(ei.value))
    assert msgs["torch"] == msgs["jax"]
