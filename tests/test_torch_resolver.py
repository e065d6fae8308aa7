"""The port's endpoint resolvers and live fleet membership
(``klogs_tpu_torch/service/resolver.py`` with ``shard.py``).

- The contracts of the JAX ``tests/test_resolver.py``, run against the
  port: the ``--resolver`` grammar and the four kinds, membership
  diffing under the ring generation, verify-before-rejoin of joiners,
  hash-ring key movement on a fleet change, capacity-weighted routing
  with its decay, churn under load with no batch dropped, and a fleet
  of port filterds (``FilterServer(device="cpu")``) rolled through a
  watched file.
- ``KubeBackend.endpoint_addresses`` against the JAX one on the same
  Endpoints documents from one local fake apiserver.
- The CLI with ``--resolver file:`` against a fleet of JAX filterds,
  byte for byte the JAX CLI's files.
"""

import asyncio
import time

import pytest

pytest.importorskip("grpc")

from test_torch_shard import FakeClient, _one_torch_thread  # noqa: E402,F401

from klogs_tpu_torch.obs import Registry, register_all  # noqa: E402
from klogs_tpu_torch.resilience import (  # noqa: E402
    FAULTS,
    InjectedFault,
    Unavailable,
)
from klogs_tpu_torch.service.client import ServiceConfigError  # noqa: E402
from klogs_tpu_torch.service.resolver import (  # noqa: E402
    DnsResolver,
    FileResolver,
    KubeEndpointsResolver,
    Resolver,
    ResolverError,
    StaticResolver,
    make_resolver,
    split_spec,
)
from klogs_tpu_torch.service.shard import ShardedFilterClient  # noqa: E402


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.clear()
    FAULTS.bind_registry(None)
    yield
    FAULTS.clear()
    FAULTS.bind_registry(None)


# ---- spec grammar ----------------------------------------------------


@pytest.mark.parametrize("spec,kind,rest", [
    ("static:a:1,b:2", "static", "a:1,b:2"),
    ("file:/etc/fleet", "file", "/etc/fleet"),
    ("dns:filterd.svc:50051", "dns", "filterd.svc:50051"),
    ("kube:logging/filterd:50051", "kube", "logging/filterd:50051"),
])
def test_split_spec_accepts_registered_kinds(spec, kind, rest):
    assert split_spec(spec) == (kind, rest)


@pytest.mark.parametrize("spec", [
    "consul:whatever", "static", "static:", "", "dnsfilterd:50051"])
def test_split_spec_rejects_malformed_naming_the_spec(spec):
    with pytest.raises(ValueError, match="--resolver"):
        split_spec(spec)


@pytest.mark.parametrize("spec,needle", [
    ("dns:no-port", "HOST:PORT"),
    ("kube:nameonly", "NAMESPACE/NAME"),
    ("kube:/name:50051", "NAMESPACE/NAME"),
])
def test_make_resolver_rejects_bad_kind_bodies(spec, needle):
    with pytest.raises(ValueError, match=needle):
        make_resolver(spec)


def test_make_resolver_builds_each_kind():
    assert isinstance(make_resolver("static:a:1"), StaticResolver)
    assert isinstance(make_resolver("file:/tmp/fleet"), FileResolver)
    assert isinstance(make_resolver("dns:h:50051"), DnsResolver)
    kube = make_resolver("kube:logging/filterd:9000")
    assert isinstance(kube, KubeEndpointsResolver)
    assert kube.describe() == "kube:logging/filterd:9000"
    # Without :PORT the subset's advertised port is used later.
    assert make_resolver("kube:logging/filterd").describe() == (
        "kube:logging/filterd")


# ---- resolver kinds --------------------------------------------------


def test_static_resolver_returns_fixed_list():
    r = make_resolver("static: a:1 , b:2 ")
    assert run(r.resolve()) == ["a:1", "b:2"]
    assert r.describe() == "static:a:1,b:2"


def test_file_resolver_reads_comments_and_blanks(tmp_path):
    p = tmp_path / "fleet"
    p.write_text("# the fleet\n a:1 \n\nb:2  # canary\n")
    r = FileResolver(str(p))
    assert run(r.resolve()) == ["a:1", "b:2"]


def test_file_resolver_missing_file_is_transient(tmp_path):
    r = FileResolver(str(tmp_path / "nope"))
    with pytest.raises(ResolverError, match="cannot read"):
        run(r.resolve())


def test_dns_resolver_brackets_ipv6_and_appends_port():
    r = DnsResolver("filterd.svc", 50051,
                    resolve_fn=lambda host: ["10.0.0.1", "fd00::2"])
    assert run(r.resolve()) == [
        "10.0.0.1:50051", "[fd00::2]:50051"]


class FakeKubeBackend:
    def __init__(self, addrs):
        self.addrs = addrs
        self.closed = False
        self.calls = 0

    async def endpoint_addresses(self, namespace, name):
        self.calls += 1
        if isinstance(self.addrs, Exception):
            raise self.addrs
        return self.addrs

    async def close(self):
        self.closed = True


def test_kube_resolver_pins_spec_port_over_advertised():
    be = FakeKubeBackend([("10.0.0.1", 8080), ("10.0.0.2", 8080)])
    r = KubeEndpointsResolver("logging", "filterd", port=50051,
                              backend_factory=lambda: be)
    assert run(r.resolve()) == ["10.0.0.1:50051", "10.0.0.2:50051"]


def test_kube_resolver_uses_advertised_port_and_closes_backend():
    be = FakeKubeBackend([("10.0.0.1", 9443)])

    async def scenario():
        r = KubeEndpointsResolver("logging", "filterd",
                                  backend_factory=lambda: be)
        got = await r.resolve()
        await r.aclose()
        return got

    assert run(scenario()) == ["10.0.0.1:9443"]
    assert be.closed


def test_kube_resolver_no_port_anywhere_is_transient():
    be = FakeKubeBackend([("10.0.0.1", None)])
    r = KubeEndpointsResolver("logging", "filterd",
                              backend_factory=lambda: be)
    with pytest.raises(ResolverError, match="advertises no port"):
        run(r.resolve())


def test_kube_resolver_cluster_error_is_transient():
    from klogs_tpu_torch.cluster.backend import ClusterError

    be = FakeKubeBackend(ClusterError("apiserver weather"))
    r = KubeEndpointsResolver("logging", "filterd", port=1,
                              backend_factory=lambda: be)
    with pytest.raises(ResolverError, match="apiserver weather"):
        run(r.resolve())


def test_resolver_watch_fault_point_fires_on_resolve():
    FAULTS.load_spec("resolver.watch:error*")
    r = StaticResolver(["a:1"])
    with pytest.raises(InjectedFault):
        run(r.resolve())


# ---- membership diffing ----------------------------------------------


class MemberClient(FakeClient):
    """FakeClient that counts MATCH dispatches separately from hello
    probes — verify-before-rejoin asserts on batches, not probes."""

    def __init__(self, target, **kw):
        super().__init__(target, **kw)
        self.matches = 0

    async def match(self, lines):
        self.matches += 1
        return await super().match(lines)


def _fleet(targets, clients=None, **kw):
    clients = {} if clients is None else clients

    def factory(target):
        c = MemberClient(target)
        clients[target] = c
        return c

    return ShardedFilterClient(list(targets), client_factory=factory,
                               hedge_s=None, **kw), clients


def test_apply_membership_adds_removes_and_bumps_ring_gen():
    sc, clients = _fleet(["a:1", "b:1"])

    async def scenario():
        gen = sc._ring_gen
        added, removed = await sc.apply_membership(["a:1", "c:1"])
        assert (added, removed) == (["c:1"], ["b:1"])
        assert sc._ring_gen == gen + 1
        assert [ep.target for ep in sc._endpoints] == ["a:1", "c:1"]
        await sc.aclose()

    run(scenario())
    assert clients["b:1"].closed  # leaver's channel retired


def test_apply_membership_noop_snapshot_changes_nothing():
    sc, _ = _fleet(["a:1", "b:1"])

    async def scenario():
        gen = sc._ring_gen
        assert await sc.apply_membership(["b:1", "a:1"]) == ([], [])
        assert sc._ring_gen == gen
        await sc.aclose()

    run(scenario())


def test_apply_membership_skips_malformed_entry_keeps_good():
    registry = Registry()
    register_all(registry)
    sc, _ = _fleet(["a:1"], registry=registry)

    async def scenario():
        added, _ = await sc.apply_membership(["a:1", "bad", "c:2"])
        assert added == ["c:2"]
        assert [ep.target for ep in sc._endpoints] == ["a:1", "c:2"]
        await sc.aclose()

    run(scenario())
    fam = registry.family("klogs_fleet_membership_events_total")
    assert fam.labels(action="error").value == 1
    assert fam.labels(action="add").value == 1
    assert registry.family("klogs_fleet_membership_size").value == 2


def test_apply_membership_refuses_to_drain_fleet_on_empty_snapshot():
    sc, _ = _fleet(["a:1", "b:1"])

    async def scenario():
        assert await sc.apply_membership([]) == ([], [])
        assert len(sc._endpoints) == 2
        await sc.aclose()

    run(scenario())


def test_joiners_enter_unverified_once_expected_config_armed():
    sc, clients = _fleet(["a:1"], probe_interval_s=0.2)

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        await sc.apply_membership(["a:1", "b:1"])
        joiner = next(ep for ep in sc._endpoints if ep.target == "b:1")
        assert not joiner.verified
        # Hold the joiner's handshake open: while it is pending the
        # joiner gets ZERO batches (_route_order excludes unverified
        # endpoints) even though dispatches keep flowing.
        clients["b:1"].delay_s = 0.5
        for _ in range(8):
            await sc.match([b"x"])
        assert clients["b:1"].matches == 0
        # Release the handshake; the prober's late-verify admits it.
        clients["b:1"].delay_s = 0.0
        await asyncio.wait_for(_until(lambda: joiner.verified), 20)
        await sc.aclose()

    run(scenario())


async def _until(pred):
    while not pred():
        await asyncio.sleep(0.01)


def test_resolver_seeds_empty_fleet_at_verify():
    sc, clients = _fleet([], resolver=StaticResolver(["a:1", "b:1"]))

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        assert sorted(clients) == ["a:1", "b:1"]
        # Pre-handshake seeds are verified by the handshake itself.
        assert all(ep.verified for ep in sc._endpoints)
        assert await sc.match([b"x"]) in (["a:1"], ["b:1"])
        await sc.aclose()

    run(scenario())


class EmptyResolver(Resolver):
    kind = "empty"

    async def _resolve(self):
        return []


def test_resolver_returning_nothing_at_startup_is_fatal():
    sc, _ = _fleet([], resolver=EmptyResolver())

    async def scenario():
        with pytest.raises(Unavailable, match="no endpoints"):
            await sc.verify_patterns(["ERROR"])
        await sc.aclose()

    run(scenario())


def test_resolver_failure_keeps_current_fleet():
    class FlakyResolver(Resolver):
        kind = "flaky"

        async def _resolve(self):
            raise ResolverError("weather")

    registry = Registry()
    register_all(registry)
    sc, _ = _fleet(["a:1", "b:1"], resolver=FlakyResolver(),
                   registry=registry)

    async def scenario():
        await sc._resolve_step()
        assert len(sc._endpoints) == 2
        await sc.aclose()

    run(scenario())
    fam = registry.family("klogs_fleet_membership_events_total")
    assert fam.labels(action="error").value == 1


def test_file_resolver_drives_live_membership(tmp_path, monkeypatch):
    """The acceptance loop in miniature: edit the fleet file, the
    prober's next poll applies the diff."""
    monkeypatch.setenv("KLOGS_RESOLVER_INTERVAL_S", "0.05")
    fleet = tmp_path / "fleet"
    fleet.write_text("a:1\nb:1\n")
    sc, clients = _fleet([], resolver=FileResolver(str(fleet)),
                         probe_interval_s=0.02)

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        assert sorted(clients) == ["a:1", "b:1"]
        fleet.write_text("a:1\nc:1\n")
        await asyncio.wait_for(_until(
            lambda: [ep.target for ep in sc._endpoints] == ["a:1", "c:1"]
        ), 20)
        await sc.aclose()

    run(scenario())
    assert clients["b:1"].closed


# ---- env knob validation (loud, at construction) ---------------------


@pytest.mark.parametrize("bad", ["nan", "inf", "-1", "soon"])
def test_bad_weight_decay_env_fails_at_construction(monkeypatch, bad):
    monkeypatch.setenv("KLOGS_WEIGHT_DECAY_S", bad)
    with pytest.raises(ServiceConfigError, match="KLOGS_WEIGHT_DECAY_S"):
        ShardedFilterClient(["a:1"], client_factory=FakeClient)


@pytest.mark.parametrize("bad", ["nan", "inf", "0", "-2"])
def test_bad_resolver_interval_env_fails_at_construction(
        monkeypatch, bad):
    monkeypatch.setenv("KLOGS_RESOLVER_INTERVAL_S", bad)
    with pytest.raises(ServiceConfigError,
                       match="KLOGS_RESOLVER_INTERVAL_S"):
        ShardedFilterClient([], client_factory=FakeClient,
                            resolver=StaticResolver(["a:1"]))
    # Without a resolver the knob is not consulted: fixed fleets pay
    # zero validation surface for a feature they don't use.
    ShardedFilterClient(["a:1"], client_factory=FakeClient)


# ---- consistent-hash key movement ------------------------------------


def _owner(targets, fingerprint):
    sc = ShardedFilterClient(list(targets), shard_mode="hash",
                             fingerprint=fingerprint,
                             client_factory=FakeClient, hedge_s=None)
    return sc._endpoints[sc._hash_order[0]].target


def test_hash_ring_moves_under_1_over_n_keys_on_join():
    before = ["a:1", "b:1", "c:1", "d:1"]
    after = before + ["e:1"]
    fps = [f"tenant-{i}" for i in range(120)]
    moved = sum(_owner(before, fp) != _owner(after, fp) for fp in fps)
    # Adding 1 of 5 should re-home ~1/5 of keys; strictly under the
    # naive-rehash 1/N (here 1/4) bound.
    assert moved / len(fps) < 1 / 4, f"moved {moved}/{len(fps)}"
    # And the survivors' keys did not churn among themselves.
    for fp in fps:
        if _owner(before, fp) != _owner(after, fp):
            assert _owner(after, fp) == "e:1"


def test_hash_ring_rehomes_only_leavers_keys_on_leave():
    before = ["a:1", "b:1", "c:1", "d:1"]
    after = ["a:1", "b:1", "c:1"]
    fps = [f"pod-{i}" for i in range(120)]
    for fp in fps:
        own = _owner(before, fp)
        if own != "d:1":
            assert _owner(after, fp) == own


# ---- capacity-weighted routing ---------------------------------------


def _healthy_heads(sc, n):
    return [sc._route_order()[0].target for _ in range(n)]


def test_weighted_order_steers_proportionally_to_headroom():
    sc, _ = _fleet(["a:1", "b:1"])
    now = time.monotonic()
    for ep in sc._endpoints:
        ep.cap_at = now
    sc._endpoints[0].weight = 0.8
    sc._endpoints[1].weight = 0.2
    heads = _healthy_heads(sc, 100)
    share_a = heads.count("a:1") / 100
    # Smooth WRR is deterministic: 0.8/0.2 weights -> 80/20 +- decay
    # drift over the 100 draws.
    assert 0.7 <= share_a <= 0.9, f"a:1 won {share_a:.2f}"
    assert heads.count("b:1") > 0  # floor: no starvation


def test_uniform_weights_keep_plain_rotation():
    sc, _ = _fleet(["a:1", "b:1"])
    heads = _healthy_heads(sc, 4)
    assert heads == ["a:1", "b:1", "a:1", "b:1"]


def test_stale_capacity_decays_to_uniform(monkeypatch):
    monkeypatch.setenv("KLOGS_WEIGHT_DECAY_S", "30")
    sc, _ = _fleet(["a:1", "b:1"])
    stale = time.monotonic() - 31.0
    for ep, w in zip(sc._endpoints, (0.9, 0.1)):
        ep.cap_at = stale
        ep.weight = w
    heads = _healthy_heads(sc, 4)
    assert heads == ["a:1", "b:1", "a:1", "b:1"]


def test_weight_decay_zero_disables_weighting(monkeypatch):
    monkeypatch.setenv("KLOGS_WEIGHT_DECAY_S", "0")
    sc, _ = _fleet(["a:1", "b:1"])
    now = time.monotonic()
    for ep, w in zip(sc._endpoints, (0.9, 0.1)):
        ep.cap_at = now
        ep.weight = w
    heads = _healthy_heads(sc, 4)
    assert heads == ["a:1", "b:1", "a:1", "b:1"]


def test_note_capacity_learns_clamped_floored_weight():
    sc, _ = _fleet(["a:1", "b:1"])
    ep = sc._endpoints[0]
    sc._note_capacity(ep, {"headroom": 1.7})
    assert ep.weight == 1.0
    sc._note_capacity(ep, {"headroom": -3.0})
    assert ep.weight == pytest.approx(0.05)  # floor, never starved
    sc._note_capacity(ep, {"headroom": True})  # bool is not a signal
    assert ep.weight == pytest.approx(0.05)
    assert ep.cap_at is not None


def test_hash_mode_ignores_weights_pins_ownership():
    sc, _ = _fleet(["a:1", "b:1"], shard_mode="hash", fingerprint="fp")
    owner = sc._route_order()[0].target
    now = time.monotonic()
    for ep in sc._endpoints:
        ep.cap_at = now
        ep.weight = 0.9 if ep.target != owner else 0.05
    assert all(sc._route_order()[0].target == owner for _ in range(8))


# ---- churn mid-soak: the chaos acceptance (fast, fakes) --------------


def test_membership_churn_mid_soak_zero_dropped_batches():
    """add -> remove -> hard-kill while senders stream: every batch is
    answered by SOME live endpoint; the killed endpoint's in-flight
    work fails over under the ring-generation guard."""
    sc, clients = _fleet(["a:1", "b:1", "c:1"],
                         probe_interval_s=0.02)

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        stop = asyncio.Event()
        answered = []

        async def sender():
            while not stop.is_set():
                answered.append(await sc.match([b"x"]))

        senders = [asyncio.create_task(sender()) for _ in range(4)]
        await asyncio.sleep(0.05)
        await sc.apply_membership(["a:1", "b:1", "c:1", "d:1"])
        d = next(ep for ep in sc._endpoints if ep.target == "d:1")
        await asyncio.wait_for(_until(lambda: d.verified), 20)
        await asyncio.sleep(0.05)
        await sc.apply_membership(["a:1", "c:1", "d:1"])  # remove b
        await asyncio.sleep(0.05)
        clients["c:1"].fail = True  # hard-kill c mid-soak
        await asyncio.sleep(0.1)
        stop.set()
        results = await asyncio.gather(*senders,
                                       return_exceptions=True)
        await sc.aclose()
        assert len(answered) > 50, "soak produced too few batches"
        return results

    results = run(scenario())
    # Zero dropped batches: no sender ever surfaced an error.
    assert all(not isinstance(r, Exception) for r in results), results
    # The joiner actually took traffic after verification.
    assert clients["d:1"].matches > 0
    # The leaver's channel was retired.
    assert clients["b:1"].closed


# ---- real-gRPC rolling-restart soak ----------------------------------


def test_soak_file_resolver_rolls_real_fleet(tmp_path, monkeypatch):
    """The chaos acceptance on REAL gRPC servers: a file-watch
    resolver rolls the fleet under a continuous batch stream — a new
    server joins (verified before its first batch), an old one is
    drained out by the file edit, a third is HARD-killed before the
    poll notices. Zero dropped batches across the whole timeline."""
    monkeypatch.setenv("KLOGS_RESOLVER_INTERVAL_S", "0.1")
    from klogs_tpu_torch.resilience import CircuitBreaker, RetryPolicy
    from klogs_tpu_torch.service.client import RemoteFilterClient
    from klogs_tpu_torch.service.server import FilterServer
    from klogs_tpu_torch import obs

    registry = obs.Registry()
    obs.register_all(registry)
    fast = RetryPolicy(max_attempts=2, base_s=0.005, max_s=0.01,
                       jitter=0.0)

    def factory(t):
        return RemoteFilterClient(
            t, retry=fast, rpc_timeout_s=2.0,
            breaker=CircuitBreaker(name=f"rpc@{t}", failure_threshold=2,
                                   reset_timeout_s=1.0,
                                   registry=registry),
            registry=registry)

    async def scenario():
        servers = {}
        for name in ("a", "b", "c"):
            srv = FilterServer(["ERROR"], device="cpu", port=0)
            port = await srv.start()
            servers[f"127.0.0.1:{port}"] = srv
        fleet = tmp_path / "fleet"
        fleet.write_text("\n".join(servers) + "\n")
        targets = list(servers)
        sc = ShardedFilterClient(
            [], resolver=FileResolver(str(fleet)), registry=registry,
            hedge_s=0.3, probe_interval_s=0.1, client_factory=factory)
        batches = registry.family("klogs_shard_batches_total")
        joiner_target = None
        try:
            await sc.verify_patterns(["ERROR"])
            for i in range(120):
                if i == 30:
                    # Roll: a new server joins, the first one leaves —
                    # both via the file, the way an operator would.
                    new_srv = FilterServer(["ERROR"], device="cpu",
                                           port=0)
                    port = await new_srv.start()
                    joiner_target = f"127.0.0.1:{port}"
                    servers[joiner_target] = new_srv
                    fleet.write_text(
                        "\n".join(targets[1:] + [joiner_target]) + "\n")
                if i == 45:
                    # The leaver only stops AFTER the poll retired it.
                    assert targets[0] not in {
                        ep.target for ep in sc._endpoints}
                    await servers[targets[0]].stop(grace=0)
                if i == 75:
                    # Hard-kill: no file edit, no warning — failover
                    # and the breaker carry it until the poll catches
                    # up with reality.
                    await servers[targets[1]].stop(grace=0)
                    fleet.write_text(
                        "\n".join(targets[2:] + [joiner_target]) + "\n")
                got = await sc.match([b"an ERROR", b"fine"])
                assert got == [True, False], f"batch {i} wrong"
                await asyncio.sleep(0.025)
            assert batches.labels(endpoint=joiner_target).value > 0, \
                "joiner never won a batch"
            assert {ep.target for ep in sc._endpoints} == {
                targets[2], joiner_target}
        finally:
            await sc.aclose()
            for srv in servers.values():
                await srv.stop()

    run(asyncio.wait_for(scenario(), timeout=120))


# ---- across the packages ---------------------------------------------


ENDPOINTS = {
    "one-port": {"subsets": [
        {"addresses": [{"ip": "10.0.0.1"}, {"ip": "10.0.0.2"}],
         "ports": [{"name": "grpc", "port": 50051}]},
        {"addresses": [{"ip": "fd00::7"}, {"hostname": "no-ip"}],
         "ports": [{"port": 50052}]}]},
    "two-ports": {"subsets": [
        {"addresses": [{"ip": "10.0.0.3"}],
         "ports": [{"port": 1}, {"port": 2}]}]},
    "no-subsets": {"metadata": {"name": "no-subsets"}},
}


async def _endpoints_side(side: str, tmp_path) -> list:
    """Each Endpoints document through the side's KubeBackend and kube
    resolver, against one local fake apiserver."""
    import yaml
    from aiohttp import web

    from klogs_tpu.cluster import kube as jax_kube
    from klogs_tpu.service import resolver as jax_resolver
    from klogs_tpu_torch.cluster import kube
    from klogs_tpu_torch.service import resolver

    kube_mod, res_mod = ((jax_kube, jax_resolver) if side == "jax"
                         else (kube, resolver))
    seen: list = []

    async def endpoints(request):
        seen.append((request.match_info["ns"], request.match_info["name"],
                     request.headers.get("Authorization")))
        doc = ENDPOINTS.get(request.match_info["name"])
        if doc is None:
            return web.Response(status=404)
        return web.json_response(doc)

    app = web.Application()
    app.router.add_get("/api/v1/namespaces/{ns}/endpoints/{name}",
                       endpoints)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    cfg = tmp_path / f"kc-{side}"
    cfg.write_text(yaml.safe_dump({
        "current-context": "t",
        "contexts": [{"name": "t", "context": {"cluster": "c",
                                              "user": "u"}}],
        "clusters": [{"name": "c", "cluster": {
            "server": f"http://127.0.0.1:{port}"}}],
        "users": [{"name": "u", "user": {"token": "tok"}}]}))
    out = []
    try:
        backend = kube_mod.KubeBackend.from_kubeconfig(str(cfg))
        try:
            for name in ("one-port", "two-ports", "no-subsets", "absent"):
                out.append(await backend.endpoint_addresses("logging", name))
        finally:
            await backend.close()
        for spec in ("kube:logging/one-port", "kube:logging/two-ports:9",
                     "kube:logging/absent:1", "kube:logging/two-ports"):
            r = res_mod.make_resolver(spec, kubeconfig=str(cfg))
            try:
                out.append(await r.resolve())
            except res_mod.ResolverError as e:
                out.append(("ResolverError", str(e)))
            finally:
                await r.aclose()
    finally:
        await runner.cleanup()
    return out + [seen]


def test_kube_endpoints_and_resolver_equal_jax(tmp_path):
    got = run(_endpoints_side("torch", tmp_path))
    exp = run(_endpoints_side("jax", tmp_path))
    assert got == exp
    assert got[0] == [("10.0.0.1", 50051), ("10.0.0.2", 50051),
                      ("fd00::7", 50052)]
    assert got[1] == [("10.0.0.3", None)] and got[2] == got[3] == []
    assert got[4] == ["10.0.0.1:50051", "10.0.0.2:50051",
                      "[fd00::7]:50052"]
    assert got[5] == ["10.0.0.3:9"] and got[6] == []
    assert got[7][0] == "ResolverError" and "no port" in got[7][1]
    assert all(auth == "Bearer tok" for _, _, auth in got[-1])


def test_cli_resolver_file_equals_jax_cli(tmp_path):
    """``--resolver file:PATH`` (the seed list in the file, no
    ``--remote``), with ``--shard-mode hash`` too: the port's CLI and
    the JAX CLI over one fleet of two JAX filterds write the same
    files, byte for byte."""
    from klogs_tpu import app as jax_app
    from klogs_tpu.cli import parse_args as jax_parse_args
    from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster
    from klogs_tpu.service import server as jax_server
    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster
    from klogs_tpu_torch.ui import term

    clock = 1_753_800_000.0
    args = ["--match", "INFO", "--match", r"WARN.*\d"]

    async def scenario():
        servers = [jax_server.FilterServer(args[1::2], backend="cpu",
                                           port=0) for _ in range(2)]
        ports = [await s.start() for s in servers]
        fleet = tmp_path / "fleet"
        fleet.write_text("# the fleet\n" + "".join(
            f"127.0.0.1:{p}\n" for p in ports))
        outs = {}
        try:
            for extra in ([], ["--shard-mode", "hash"]):
                for side in ("jax", "torch"):
                    out_dir = tmp_path / f"{side}{len(extra)}"
                    argv = ["-n", "default", "-a", "-p", str(out_dir),
                            *args, *extra, "--resolver", f"file:{fleet}"]
                    if side == "jax":
                        fc = JaxFakeCluster.synthetic(
                            n_pods=4, n_containers=1,
                            lines_per_container=60, clock=lambda: clock)
                        rc = await jax_app.run_async(jax_parse_args(argv),
                                                     backend=fc)
                    else:
                        fc = FakeCluster.synthetic(
                            n_pods=4, n_containers=1,
                            lines_per_container=60, clock=lambda: clock)
                        rc = await app.run_async(cli.parse_args(argv),
                                                 backend=fc)
                    assert rc == 0
                    outs[(side, len(extra))] = {
                        f: (out_dir / f).read_bytes()
                        for f in sorted(os.listdir(out_dir))}
        finally:
            for s in servers:
                await s.stop()
        return outs

    import os

    term.set_colors(False)
    try:
        outs = run(asyncio.wait_for(scenario(), timeout=60))
    finally:
        term.set_colors(None)
    for n in (0, 2):
        assert outs[("torch", n)] == outs[("jax", n)]
        assert len(outs[("torch", n)]) == 4
        assert any(outs[("torch", n)].values())
