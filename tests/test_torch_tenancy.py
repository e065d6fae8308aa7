"""The port's multi-set filterd (``klogs_tpu_torch/service/tenancy.py``
and the server's and client's register path).

- The contracts of the JAX ``tests/test_tenancy.py``, run against the
  port: weighted-fair admission, content-addressed reuse and the
  single-flight build, quota shed through the degrade path, cold-set
  eviction and transparent registration again, the single-set wire
  left as it was, and one abusive tenant that cannot push a
  well-behaved tenant's latency past its bound. Registries build the
  port's GpuEngineFilter on the CPU (the kernels' plain versions), and
  servers are ``FilterServer(device="cpu")``.
- Across the packages: the port's registry and the JAX one, driven by
  one script under one fake clock, give the same set ids, sheds,
  evictions and order of fair admission; a JAX client registers with a
  port ``--multi-set`` server.
"""

import asyncio
import time

import pytest

pytest.importorskip("grpc")

from test_torch_shard import _one_torch_thread  # noqa: E402,F401

from klogs_tpu_torch import obs
from klogs_tpu_torch.filters.base import FilterStats, frame_lines
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience import Unavailable
from klogs_tpu_torch.service import transport
from klogs_tpu_torch.service.client import (
    PatternMismatch,
    RemoteFilterClient,
    ShedByServer,
    check_server_config,
)
from klogs_tpu_torch.service.server import FilterServer, banner_line
from klogs_tpu_torch.service.shard import pattern_fingerprint
from klogs_tpu_torch.service.tenancy import (
    FairGate,
    OverQuota,
    PatternSetRegistry,
    SetNotRegistered,
    _Lane,
)


def _engine(patterns, ignore_case=False):
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter

    return GpuEngineFilter(patterns, ignore_case=ignore_case, device="cpu")


def _factory(patterns, exclude, ignore_case):
    """The port's engine on the CPU, as a registry's sets build it."""
    from klogs_tpu_torch.filters.base import build_include_exclude

    return build_include_exclude(
        lambda pats: _engine(pats, ignore_case), patterns, exclude)


def _oracle(patterns, lines):
    import re

    rx = [re.compile(p.encode()) for p in patterns]
    return [any(r.search(ln.rstrip(b"\n")) for r in rx) for ln in lines]


# -- FairGate: start-time fair queuing --------------------------------

def test_fair_gate_interleaves_a_flood_with_a_quiet_lane():
    async def run():
        gate = FairGate(1)
        flood = _Lane("flood", 1.0, 10**9)
        quiet = _Lane("quiet", 1.0, 10**9)
        hold = _Lane("hold", 1.0, 10**9)
        await gate.acquire(hold, 1)  # occupy the only slot
        order = []

        async def one(lane, name, cost):
            async with gate.slot(lane, cost):
                order.append(name)

        tasks = [asyncio.ensure_future(one(flood, f"f{i}", 100))
                 for i in range(4)]
        for _ in range(5):
            await asyncio.sleep(0)
        tasks.append(asyncio.ensure_future(one(quiet, "q0", 100)))
        for _ in range(5):
            await asyncio.sleep(0)
        assert gate.waiting == 5
        gate.release()
        await asyncio.gather(*tasks)
        # The flood advanced its own virtual time; the quiet lane's
        # first batch (tag at the floor) overtakes everything but the
        # flood's first.
        assert order == ["f0", "q0", "f1", "f2", "f3"]

    asyncio.run(run())


def test_fair_gate_weights_scale_the_share():
    async def run():
        gate = FairGate(1)
        heavy = _Lane("heavy", 4.0, 10**9)
        light = _Lane("light", 1.0, 10**9)
        hold = _Lane("hold", 1.0, 10**9)
        await gate.acquire(hold, 1)
        order = []

        async def one(lane, name, cost):
            async with gate.slot(lane, cost):
                order.append(name)

        tasks = []
        for i in range(4):
            tasks.append(asyncio.ensure_future(one(heavy, f"h{i}", 100)))
            await asyncio.sleep(0)
        for i in range(4):
            tasks.append(asyncio.ensure_future(one(light, f"l{i}", 100)))
            await asyncio.sleep(0)
        for _ in range(5):
            await asyncio.sleep(0)
        gate.release()
        await asyncio.gather(*tasks)
        # weight 4 advances 25 virtual units per batch vs 100: the
        # heavy lane lands its whole burst before light's second.
        assert order.index("l1") > order.index("h3")
        assert order[:2] == ["h0", "l0"]

    asyncio.run(run())


def test_fair_gate_cancelled_waiter_releases_nothing_it_lacked():
    async def run():
        gate = FairGate(1)
        lane = _Lane("x", 1.0, 10**9)
        await gate.acquire(lane, 1)
        t = asyncio.ensure_future(gate.acquire(lane, 1))
        await asyncio.sleep(0)
        t.cancel()
        with pytest.raises(asyncio.CancelledError):
            await t
        gate.release()
        # Slot is free again: a fresh acquire succeeds immediately.
        await asyncio.wait_for(gate.acquire(lane, 1), 1.0)

    asyncio.run(run())


# -- registry: content-addressed reuse, eviction ----------------------

def test_registry_content_addressed_reuse():
    async def run():
        reg = PatternSetRegistry(_factory, max_sets=8)
        try:
            fp1, shared1 = await reg.register(["ERROR"], [], False)
            fp2, shared2 = await reg.register(["ERROR"], [], False)
            assert fp1 == fp2 and not shared1 and shared2
            assert reg.engine_builds == 1  # acceptance counter
            assert reg.count == 1
            fp3, _ = await reg.register(["WARN"], [], False)
            assert fp3 != fp1 and reg.engine_builds == 2
            # ignore_case is part of the identity
            fp4, _ = await reg.register(["ERROR"], [], True)
            assert fp4 != fp1 and reg.engine_builds == 3
        finally:
            await reg.aclose()

    asyncio.run(run())


def test_registry_single_flight_concurrent_registrations():
    calls = []

    def slow_factory(patterns, exclude, ignore_case):
        calls.append(patterns)
        time.sleep(0.05)  # runs in to_thread
        return _engine(patterns, ignore_case)

    async def run():
        reg = PatternSetRegistry(slow_factory, max_sets=8)
        try:
            got = await asyncio.gather(
                *[reg.register(["X.*Y"], [], False) for _ in range(6)])
            assert len({fp for fp, _ in got}) == 1
            assert sum(1 for _, shared in got if not shared) == 1
            assert len(calls) == 1 and reg.engine_builds == 1
        finally:
            await reg.aclose()

    asyncio.run(run())


def test_cancelled_builder_does_not_poison_concurrent_registrants():
    """A rider of a single-flight build whose BUILDER was cancelled
    rebuilds the set itself; its own cancellation still propagates."""

    def slow_factory(patterns, exclude, ignore_case):
        time.sleep(0.15)
        return _engine(patterns, ignore_case)

    async def run():
        reg = PatternSetRegistry(slow_factory, max_sets=8)
        try:
            builder = asyncio.ensure_future(
                reg.register(["S.*T"], [], False))
            await asyncio.sleep(0.03)  # builder is mid-compile
            rider = asyncio.ensure_future(
                reg.register(["S.*T"], [], False))
            await asyncio.sleep(0.03)
            builder.cancel()
            with pytest.raises(asyncio.CancelledError):
                await builder
            # The innocent rider rebuilds and succeeds.
            fp, shared = await asyncio.wait_for(rider, 5.0)
            assert not shared and reg.get(fp) is not None
        finally:
            await reg.aclose()

    asyncio.run(run())


def test_double_eviction_degrades_instead_of_killing_the_run():
    """Evicted again right after the transparent re-register =
    registry capacity churn -> Unavailable (degrade/failover path), not
    a fatal ClusterError."""

    async def fn(server, port):
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["WARN"])
            fp = c._set_id
            await server.tenants.evict(fp, "capacity")

            async def no_op_register():
                return None  # simulates the re-registered set being
                # evicted again before the retry lands

            c._register_set = no_op_register
            with pytest.raises(Unavailable, match="churn"):
                await c.match([b"WARN 1"])
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn))


def test_registry_capacity_lru_eviction_and_reregister():
    async def run():
        reg = PatternSetRegistry(_factory, max_sets=2)
        try:
            fp_a, _ = await reg.register(["AAA"], [], False)
            fp_b, _ = await reg.register(["BBB"], [], False)
            # Touch A so B is the LRU victim when C arrives.
            await reg.match(fp_a, [b"AAA 1"])
            fp_c, _ = await reg.register(["CCC"], [], False)
            assert reg.count == 2
            assert reg.get(fp_b) is None and reg.get(fp_a) is not None
            with pytest.raises(SetNotRegistered):
                await reg.match(fp_b, [b"BBB"])
            # Re-registration revives it (and evicts the new LRU).
            fp_b2, shared = await reg.register(["BBB"], [], False)
            assert fp_b2 == fp_b and not shared
            assert (await reg.match(fp_b, [b"BBB", b"zzz"])) == [True, False]
        finally:
            await reg.aclose()

    asyncio.run(run())


def test_registry_idle_sweeper_evicts_cold_sets():
    async def run():
        reg = PatternSetRegistry(_factory, max_sets=8, idle_evict_s=0.1)
        stop = asyncio.Event()
        sweeper = asyncio.ensure_future(
            reg.run_idle_sweeper(stop, interval_s=0.03))
        try:
            fp, _ = await reg.register(["COLD"], [], False)
            assert reg.count == 1
            deadline = time.monotonic() + 2.0
            while reg.count and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            assert reg.count == 0, "idle set was never evicted"
            # Re-register after eviction: fresh engine, same id.
            fp2, shared = await reg.register(["COLD"], [], False)
            assert fp2 == fp and not shared and reg.engine_builds == 2
        finally:
            stop.set()
            await sweeper
            await reg.aclose()

    asyncio.run(run())


def test_registry_quota_shed_is_loud_and_counted():
    async def run():
        r = obs.Registry()
        obs.register_all(r)
        stats = FilterStats(registry=r)
        reg = PatternSetRegistry(_factory, stats=stats, max_sets=4,
                                 quota_lines=10)
        try:
            fp, _ = await reg.register(["E"], [], False)
            with pytest.raises(OverQuota) as ei:
                await reg.match(fp, [b"x"] * 11)
            assert isinstance(ei.value, Unavailable)  # degrade-path type
            assert "KLOGS_TENANT_QUOTA_LINES" in str(ei.value)
            shed = r.family("klogs_tenant_shed_total").labels(set=fp)
            assert shed.value == 1
            # Under quota passes, and the lane accounting drains.
            assert (await reg.match(fp, [b"has E", b"nope"])) == [True,
                                                                  False]
            assert reg.get(fp).lane.pending_lines == 0
        finally:
            await reg.aclose()

    asyncio.run(run())


# -- transport codecs ---------------------------------------------------

def test_register_request_codec_validates():
    good = transport.decode_register_request(
        transport.encode_register_request(["a"], ["b"], True, 2.0))
    assert good == {"patterns": ["a"], "exclude": ["b"],
                    "ignore_case": True, "weight": 2.0}
    for doc in ({"patterns": "a"}, {"patterns": []},
                {"patterns": ["a"], "weight": 0},
                {"patterns": ["a"], "weight": "x"},
                {"patterns": [1]}):
        with pytest.raises((ValueError, TypeError)):
            transport.decode_register_request(transport.pack(doc))


def test_framed_request_set_id_roundtrip_and_validation():
    import numpy as np

    payload, offsets, _ = frame_lines([b"ab", b"c"])
    enc = transport.encode_framed_request(payload, offsets, set_id="ff00")
    p2, o2, sid = transport.decode_framed_request(enc)
    assert sid == "ff00" and p2 == payload
    assert np.array_equal(o2, offsets)
    # Untagged stays None (single-set wire shape unchanged).
    _, _, sid = transport.decode_framed_request(
        transport.encode_framed_request(payload, offsets))
    assert sid is None
    bad = transport.pack({"n": 1, "offs": offsets[:2].tobytes(),
                          "data": b"ab", "set": 7})
    with pytest.raises(ValueError):
        transport.decode_framed_request(bad)


def test_hello_request_codec_is_lenient_for_legacy_bodies():
    assert transport.decode_hello_request(b"") is None
    assert transport.decode_hello_request(b"\x01garbage") is None
    got = transport.decode_hello_request(
        transport.encode_hello_request(["p"], ["x"], True))
    assert got == {"patterns": ["p"], "exclude": ["x"],
                   "ignore_case": True}


# -- server/client e2e ------------------------------------------------

async def _with_multi_server(fn, patterns=("ERROR",), **kw):
    server = FilterServer(list(patterns), device="cpu", port=0,
                          multi_set=True, **kw)
    port = await server.start()
    try:
        return await fn(server, port)
    finally:
        await server.stop()


def test_second_collector_registers_instead_of_mismatch():
    """A multi-set server answers verify_patterns against the registry — a different set registers; a single-set server still
    hard-fails PatternMismatch."""

    async def fn(server, port):
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["WARN.*x"])  # != startup set
            assert c._set_id is not None
            assert server.tenants.count == 2
            got = await c.match([b"WARN zx", b"an ERROR", b"meh"])
            assert got == [True, False, False]
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn))

    async def single():
        server = FilterServer(["ERROR"], device="cpu", port=0)
        port = await server.start()
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            with pytest.raises(PatternMismatch):
                await c.verify_patterns(["WARN.*x"])
        finally:
            await c.aclose()
            await server.stop()

    asyncio.run(single())


def test_single_set_hello_stays_byte_identical():
    """The single-set wire contract must not grow registry keys."""

    async def run():
        server = FilterServer(["ERROR"], device="cpu", port=0)
        port = await server.start()
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            info = await c.hello()
            # Registry keys (multi_set/sets/set/registered) must not
            # leak into the single-set handshake; the capacity trio is
            # advertised in BOTH modes by design (fleet telemetry).
            assert set(info) == {"patterns", "exclude", "ignore_case",
                                 "backend", "version", "framed",
                                 "metrics_port", "metrics_host",
                                 "device_sweep", "headroom",
                                 "fleet_offered_lines",
                                 "fleet_admitted_lines"}
        finally:
            await c.aclose()
            await server.stop()

    asyncio.run(run())


def test_legacy_untagged_client_rides_the_default_set():
    """Single-tenant parity: an old client that never registers gets
    the startup set's verdicts, same as against a single-set server."""

    async def fn(server, port):
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["ERROR"])  # matches default set
            lines = [b"an ERROR here", b"fine", b"ERRORS galore"]
            got = await c.match(lines)
            assert got == _oracle(["ERROR"], lines)
            payload, offsets, _ = frame_lines(lines)
            mask = await c.match_framed(payload, offsets)
            assert mask.tolist() == got
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn))


def test_eviction_reregister_roundtrip_is_transparent():
    """A match against an evicted set re-registers and retries without
    the caller noticing; the rebuilt engine is a NEW compile."""

    async def fn(server, port):
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["WARN"])
            fp = c._set_id
            assert (await c.match([b"WARN 1", b"no"])) == [True, False]
            builds = server.tenants.engine_builds
            assert await server.tenants.evict(fp, "idle")
            # Transparent: same call, correct verdicts, one rebuild.
            assert (await c.match([b"WARN 2", b"no"])) == [True, False]
            assert server.tenants.engine_builds == builds + 1
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn))


def test_registry_only_server_and_unknown_set_is_loud():
    """No startup set: untagged match RPCs fail FAILED_PRECONDITION
    with a register-first message instead of filtering with nothing."""

    async def fn(server, port):
        from klogs_tpu_torch.cluster.backend import ClusterError

        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            info = await c.hello()
            assert info["multi_set"] is True and info["sets"] == 0
            assert info["registered"] is False
            with pytest.raises(ClusterError, match="register"):
                await c.match([b"x"])
            await c.verify_patterns(["OK"])
            assert (await c.match([b"OK then", b"no"])) == [True, False]
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn, patterns=()))


def test_banner_and_hello_report_registry_mode():
    async def fn(server, port):
        line = banner_line(server, f"127.0.0.1:{port}", "plaintext")
        assert "pattern-set registry (1 live set(s)" in line
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["WARN"])
            info = await c.hello()
            assert info["multi_set"] is True
            assert info["sets"] == 2 and info["registered"] is True
            assert info["set"] == pattern_fingerprint(["WARN"], [], False)
            assert "2 live set(s)" in banner_line(
                server, f"127.0.0.1:{port}", "plaintext")
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn))

    # Single-set banner unchanged.
    async def single():
        server = FilterServer(["A", "B"], device="cpu", port=0)
        try:
            assert banner_line(server, "h:1", "plaintext") == (
                "klogs filterd: serving 2 pattern(s) [cuda] on h:1 "
                "(plaintext)")
        finally:
            await server._service.aclose()

    asyncio.run(single())


def test_check_server_config_multi_set_contract():
    # Multi-set servers never "drift": every verification is a
    # (content-addressed, idempotent) registration — even when the set
    # is already live, the client still needs its id and the LRU clock
    # its touch.
    info = {"multi_set": True, "registered": True,
            "set": pattern_fingerprint(["A"], [], False)}
    assert check_server_config("t", info, ["A"], False, []) == "register"
    assert check_server_config(
        "t", {"multi_set": True}, ["A"], False, []) == "register"
    # Single-set servers keep the strict handshake.
    single = {"patterns": ["A"], "exclude": [], "ignore_case": False}
    assert check_server_config("t", single, ["A"], False, []) == "ok"
    with pytest.raises(PatternMismatch):
        check_server_config("t", single, ["B"], False, [])


def test_tenant_attr_on_spans():
    """Trace spans carry the tenant so a flight dump attributes a stall
    to the offending set."""
    trace.reset(1.0)
    try:
        async def fn(server, port):
            c = RemoteFilterClient(f"127.0.0.1:{port}")
            try:
                await c.verify_patterns(["WARN"])
                await c.match([b"WARN 1"])
            finally:
                await c.aclose()
            return c._set_id

        fp = asyncio.run(_with_multi_server(fn))
        spans = trace.TRACER.finished_spans()
        admits = [d for d in spans if d["name"] == "tenant.admit"]
        assert admits and all(d["attrs"]["tenant"] == fp for d in admits)
        servers = [d for d in spans if d["name"] == "rpc.server"
                   and d["attrs"].get("method") == "Match"]
        assert servers and servers[-1]["attrs"]["tenant"] == fp
        regs = [d for d in spans if d["name"] == "rpc.server"
                and d["attrs"].get("method") == "Register"]
        assert regs and regs[0]["attrs"]["tenant"] == fp
    finally:
        trace.reset(None)


def test_tenant_weight_env_reaches_the_server_lane(monkeypatch):
    """KLOGS_TENANT_WEIGHT rides the Register RPC: the server lane
    carries it (highest wins for a shared set), and garbage fails
    loudly naming the variable."""
    from klogs_tpu_torch.service.client import ServiceConfigError, tenant_weight

    async def fn(server, port):
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["WARN"])
            assert server.tenants.get(c._set_id).lane.weight == 4.0
        finally:
            await c.aclose()

    monkeypatch.setenv("KLOGS_TENANT_WEIGHT", "4.0")
    asyncio.run(_with_multi_server(fn))
    for bad in ("0", "-1", "nan", "inf", "x", "2048"):
        monkeypatch.setenv("KLOGS_TENANT_WEIGHT", bad)
        with pytest.raises(ServiceConfigError, match="KLOGS_TENANT_WEIGHT"):
            tenant_weight()


def test_capacity_cap_excludes_the_pinned_default_set():
    """The cap counts REGISTERED sets only — a max_sets=1
    server with a pinned default must not evict a tenant the instant
    it registers (permanent register/FAILED_PRECONDITION loop)."""

    async def fn(server, port):
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["WARN"])
            # The freshly registered set is alive despite max_sets=1.
            assert server.tenants.get(c._set_id) is not None
            assert (await c.match([b"WARN 1", b"no"])) == [True, False]
            # And the pinned default still serves untagged traffic.
            assert server.tenants.get(server.default_set) is not None
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn, tenant_max_sets=1))


def test_match_with_bad_set_type_fails_its_own_rpc():
    """A non-string set id on Match fails INVALID_ARGUMENT
    like the framed path, not an UNKNOWN server traceback."""

    async def fn(server, port):
        import grpc

        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            raw = c._channel.unary_unary(transport.MATCH)
            with pytest.raises(grpc.aio.AioRpcError) as ei:
                await raw(transport.pack({"lines": [b"x"], "set": 7}))
            assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn))


def test_shard_startup_survives_endpoint_dying_before_register():
    """An endpoint that answers Hello but dies before
    Register is excluded (late-verified later), not a fatal collector
    startup error."""
    from klogs_tpu_torch.service.shard import ShardedFilterClient

    class _FakeClient:
        def __init__(self, target, dead=False):
            self.target = target
            self._dead = dead
            self.registered = False

        async def hello(self):
            return {"multi_set": True, "framed": True, "sets": 0,
                    "registered": False}

        async def ensure_registered(self, patterns, ignore_case,
                                    exclude=None):
            if self._dead:
                raise Unavailable(f"{self.target} went away")
            self.registered = True

        async def aclose(self):
            pass

    async def run():
        fakes = {}

        def factory(target):
            fakes[target] = _FakeClient(target, dead=target.endswith("2"))
            return fakes[target]

        sc = ShardedFilterClient(["h:1", "h:2"], hedge_s=None,
                                 client_factory=factory)
        try:
            await sc.verify_patterns(["P"], False, exclude=[])
            assert fakes["h:1"].registered
            eps = {ep.target: ep for ep in sc._endpoints}
            assert eps["h:1"].verified and not eps["h:2"].verified
        finally:
            await sc.aclose()

    asyncio.run(run())


def test_eviction_removes_per_set_metric_series():
    """The `set` label's cardinality is bounded by LIVE
    sets — eviction must drop the evicted fingerprint's series, or a
    churning registry grows dead series (and a stale pending gauge)
    forever."""

    async def run():
        r = obs.Registry()
        obs.register_all(r)
        stats = FilterStats(registry=r)
        reg = PatternSetRegistry(_factory, stats=stats, max_sets=4)
        try:
            fp, _ = await reg.register(["GONE"], [], False)
            await reg.match(fp, [b"GONE 1"])
            fam = r.family("klogs_tenant_pending_lines")
            assert any(k == (fp,) for k, _ in fam.children())
            assert await reg.evict(fp, "idle")
            for name in ("klogs_tenant_pending_lines",
                         "klogs_tenant_shed_total",
                         "klogs_tenant_lines_total"):
                assert all(k != (fp,)
                           for k, _ in r.family(name).children()), name
        finally:
            await reg.aclose()

    asyncio.run(run())


def test_default_set_shares_the_registry_device_budget():
    """In --multi-set mode the pinned startup service must
    ride the registry's shared fetch pool + in-flight semaphore, or
    legacy un-tagged traffic doubles the one-device budget."""

    async def fn(server, port):
        assert server._service._pool is server.tenants.executor
        assert server._service._sem is server.tenants.in_flight
        assert server._service._own_pool is False
        c = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(["WARN"])
            entry = server.tenants.get(c._set_id)
            assert entry.service._pool is server.tenants.executor
        finally:
            await c.aclose()

    asyncio.run(_with_multi_server(fn))

    # Single-set servers keep owning their pool (path unchanged).
    async def single():
        server = FilterServer(["A"], device="cpu", port=0)
        try:
            assert server._service._own_pool is True
        finally:
            await server._service.aclose()

    asyncio.run(single())


def test_sharded_fleet_of_multi_set_servers():
    """A collector fleet with heterogeneous --match sets can share one
    filterd tier: the sharded client registers its set on EVERY
    endpoint at startup, so any routed batch filters correctly."""
    from klogs_tpu_torch.service.shard import ShardedFilterClient

    async def run():
        servers = [FilterServer(["ERROR"], device="cpu", port=0,
                                multi_set=True) for _ in range(2)]
        ports = [await s.start() for s in servers]
        targets = [f"127.0.0.1:{p}" for p in ports]
        sc = ShardedFilterClient(targets, shard_mode="round-robin",
                                 hedge_s=None)
        try:
            await sc.verify_patterns(["WARN"], False, exclude=[])
            for s in servers:
                assert s.tenants.count == 2  # default + WARN, per shard
            lines = [b"WARN a", b"ERROR b", b"quiet"]
            payload, offsets, _ = frame_lines(lines)
            # Several batches so round-robin touches both endpoints.
            for _ in range(4):
                mask = await sc.match_framed(payload, offsets)
                assert mask.tolist() == [True, False, False]
        finally:
            await sc.aclose()
            for s in servers:
                await s.stop()

    asyncio.run(run())


# -- chaos: one abusive tenant -----------------------------------------

class _ReFilter:
    """A host ``re`` engine with the engine's framed interface: the JAX
    chaos scenario runs its host engine, and the port's engine on the
    CPU (the plain kernel versions, run on the event loop) would time
    the plain versions rather than the admission under test."""

    def __init__(self, patterns, exclude, ignore_case):
        import re

        flags = re.IGNORECASE if ignore_case else 0
        self._inc = [re.compile(p.encode(), flags) for p in patterns]
        self._exc = [re.compile(p.encode(), flags) for p in exclude]

    def dispatch_framed(self, payload, offsets):
        import numpy as np

        o = np.asarray(offsets).tolist()
        out = []
        for i in range(len(o) - 1):
            ln = payload[o[i]:o[i + 1]]
            keep = not self._inc or any(r.search(ln) for r in self._inc)
            out.append(keep and not any(r.search(ln) for r in self._exc))
        return np.asarray(out, dtype=bool)

    def fetch_framed(self, handle):
        return handle

    def close(self):
        pass


async def _chaos(duration_s: float, quota: int):
    """One abusive tenant floods its lane; a well-behaved tenant keeps
    sending small batches. Returns (latencies, sheds, server, fps). The
    registered sets build ``_ReFilter``."""
    server = FilterServer(["ERROR"], device="cpu", port=0,
                          multi_set=True, metrics_port=0,
                          tenant_quota_lines=quota,
                          tenant_idle_s=0.0)
    server.tenants._filter_factory = _ReFilter
    port = await server.start()
    good = RemoteFilterClient(f"127.0.0.1:{port}")
    twin = RemoteFilterClient(f"127.0.0.1:{port}")
    abusive = RemoteFilterClient(f"127.0.0.1:{port}")
    try:
        await good.verify_patterns(["GOOD"])
        builds_before_twin = server.tenants.engine_builds
        # Acceptance: a tenant sharing the fingerprint shares the
        # engine — the compile counter must NOT advance.
        await twin.verify_patterns(["GOOD"])
        assert server.tenants.engine_builds == builds_before_twin
        assert twin._set_id == good._set_id
        await abusive.verify_patterns(["BAD.*x"])
        assert server.tenants.count == 3  # default + GOOD + BAD

        stop = time.monotonic() + duration_s
        sheds = 0
        flood_payload, flood_offsets, _ = frame_lines(
            [b"BAD %dx or not" % i for i in range(1200)])

        async def flooder():
            nonlocal sheds
            while time.monotonic() < stop:
                try:
                    await abusive.match_framed(flood_payload,
                                               flood_offsets)
                except ShedByServer:
                    sheds += 1
                    await asyncio.sleep(0.002)

        flooders = [asyncio.ensure_future(flooder()) for _ in range(6)]
        latencies = []
        lines = [b"a GOOD line", b"background noise", b"GOODness"]
        payload, offsets, _ = frame_lines(lines)
        while time.monotonic() < stop:
            t0 = time.perf_counter()
            mask = await good.match_framed(payload, offsets)
            latencies.append(time.perf_counter() - t0)
            assert mask.tolist() == [True, False, True]
            await asyncio.sleep(0.01)
        await asyncio.gather(*flooders)
        return latencies, sheds, server, (good._set_id, abusive._set_id)
    finally:
        await good.aclose()
        await twin.aclose()
        await abusive.aclose()
        await server.stop()


def test_chaos_abusive_tenant_cannot_break_siblings_slo():
    """3+ registered tenants, one flooding its lane
    past quota — the well-behaved tenant's p99 stays under SLO,
    over-quota batches are shed via the counted degrade path, and the
    shared-fingerprint pair provably shares one engine."""

    async def run():
        return await _chaos(duration_s=2.5, quota=3000)

    latencies, sheds, server, (fp_good, fp_bad) = asyncio.run(run())
    assert len(latencies) >= 20
    latencies.sort()
    p50 = latencies[len(latencies) // 2]
    p99 = latencies[min(int(len(latencies) * 0.99),
                        len(latencies) - 1)]
    # SLO, chosen to discriminate starvation from machine noise:
    # healthy baseline is ~15ms per small batch (incl. the coalesce
    # window), so a sub-500ms MEDIAN proves the lane is not queueing
    # behind the flood (starvation inflates every sample, not just the
    # tail), while the p99 bound stays loose enough that one scheduler
    # hiccup on a loaded CI core (observed: a single 1.5s outlier in
    # ~150 samples under a full-suite run) cannot flake the gate.
    assert p50 < 0.5, f"well-behaved p50 {p50 * 1e3:.1f}ms: lane starved"
    assert p99 < 2.5, f"well-behaved p99 {p99 * 1e3:.1f}ms broke SLO"
    # The flood was actually abusive, and every shed is accounted: the
    # server-side counter matches the client-observed degrades exactly
    # (no silent drops).
    assert sheds > 0
    shed_counter = server.registry.family(
        "klogs_tenant_shed_total").labels(set=fp_bad).value
    assert shed_counter == sheds
    assert server.registry.family(
        "klogs_tenant_shed_total").labels(set=fp_good).value == 0


def test_chaos_soak_longer_window():
    """Longer soak of the same scenario: sustained flood, same SLO."""

    async def run():
        return await _chaos(duration_s=10.0, quota=3000)

    latencies, sheds, server, _ = asyncio.run(run())
    latencies.sort()
    p50 = latencies[len(latencies) // 2]
    p99 = latencies[min(int(len(latencies) * 0.99), len(latencies) - 1)]
    assert p50 < 0.5 and p99 < 2.5 and sheds > 0


# -- across the packages -----------------------------------------------


def _jax_factory(patterns, exclude, ignore_case):
    from klogs_tpu.filters.base import build_include_exclude
    from klogs_tpu.filters.cpu import best_host_filter

    return build_include_exclude(
        lambda pats: best_host_filter(pats, ignore_case=ignore_case)[0],
        patterns, exclude)


async def _registry_script(side: str, clock: list) -> list:
    """One script of registrations, matches, sheds and evictions on the
    side's registry, its clock stepped by the script: what each step
    gave, and the tenant series at the end."""
    if side == "jax":
        from klogs_tpu import obs as o
        from klogs_tpu.filters.base import FilterStats as Stats
        from klogs_tpu.service import tenancy as t

        factory = _jax_factory
    else:
        from klogs_tpu_torch import obs as o
        from klogs_tpu_torch.filters.base import FilterStats as Stats
        from klogs_tpu_torch.service import tenancy as t

        factory = _factory
    r = o.Registry()
    o.register_all(r)
    reg = t.PatternSetRegistry(factory, stats=Stats(registry=r),
                               max_sets=2, quota_lines=10,
                               idle_evict_s=100.0, slots=1)
    out = []

    async def step(at, what, coro):
        clock[0] = at
        try:
            got = await coro
        except (t.OverQuota, t.SetNotRegistered) as e:
            got = (type(e).__name__, str(e))
        out.append((what, got if not hasattr(got, "tolist")
                    else got.tolist()))

    a = pattern_fingerprint(["AAA"], [], False)
    b = pattern_fingerprint(["BBB"], ["x"], True)
    try:
        await step(0, "reg a", reg.register(["AAA"], [], False))
        await step(1, "reg b", reg.register(["BBB"], ["x"], True,
                                            weight=2.0))
        await step(2, "reg a again", reg.register(["AAA"], [], False,
                                                  weight=3.0))
        await step(3, "match a", reg.match(a, [b"AAA 1", b"no"]))
        await step(4, "reg c", reg.register(["CCC"], [], False))
        await step(5, "shed a", reg.match(a, [b"x"] * 11))
        await step(6, "match b", reg.match(b, [b"bbb"]))
        payload, offsets, _ = frame_lines([b"CCC", b"ccc", b"xCCCx"])
        await step(7, "framed c", reg.match_framed(
            pattern_fingerprint(["CCC"], [], False), payload, offsets))
        out.append(("live", reg.fingerprints(), reg.engine_builds,
                    reg.get(a).lane.weight))
        clock[0] = 200
        stop = asyncio.Event()
        sweeper = asyncio.ensure_future(
            reg.run_idle_sweeper(stop, interval_s=0.01))
        for _ in range(500):
            if not reg.count:
                break
            await asyncio.sleep(0.01)
        stop.set()
        await sweeper
        out.append(("after idle", reg.fingerprints()))
        series = {}
        for name in ("klogs_tenant_sets", "klogs_tenant_registrations_total",
                     "klogs_tenant_engine_builds_total",
                     "klogs_tenant_evictions_total",
                     "klogs_tenant_shed_total", "klogs_tenant_lines_total"):
            series[name] = [(k, c.value) for k, c in
                            r.family(name).children()]
        out.append(("series", series))
    finally:
        await reg.aclose()
    return out


def test_registry_equals_jax_under_one_fake_clock(monkeypatch):
    """The same set ids, shared flags, sheds, LRU and idle evictions,
    weights and tenant series from the port's registry as from the JAX
    one, the two clocks stepped alike."""
    import types

    from klogs_tpu.service import tenancy as jax_tenancy
    from klogs_tpu_torch.service import tenancy

    clock = [0.0]
    fake = types.SimpleNamespace(monotonic=lambda: clock[0],
                                 perf_counter=time.perf_counter)
    monkeypatch.setattr(tenancy, "time", fake)
    monkeypatch.setattr(jax_tenancy, "time", fake)
    got = asyncio.run(_registry_script("torch", clock))
    exp = asyncio.run(_registry_script("jax", clock))
    assert got == exp
    steps = dict((s[0], s[1]) for s in got if len(s) == 2)
    assert steps["reg a again"][1] is True
    assert steps["shed a"][0] == "OverQuota"
    assert steps["match b"][0] == "SetNotRegistered"
    assert steps["framed c"] == [True, False, True]
    assert got[-2] == ("after idle", [])


@pytest.mark.parametrize("seed", range(4))
def test_fair_admission_order_equals_jax(seed):
    """One seeded stream of admissions over four lanes of different
    weights through a one-slot gate: the port's FairGate grants them in
    the JAX gate's order."""
    import random

    from klogs_tpu.service import tenancy as jax_tenancy
    from klogs_tpu_torch.service import tenancy

    rng = random.Random(seed)
    plan = [(rng.randrange(4), rng.randrange(1, 500))
            for _ in range(40)]
    weights = [1.0, 2.0, 4.0, 0.5]

    async def order(mod) -> list:
        gate = mod.FairGate(1)
        lanes = [mod._Lane(f"l{i}", w, 10**9) for i, w in
                 enumerate(weights)]
        hold = mod._Lane("hold", 1.0, 10**9)
        await gate.acquire(hold, 1)
        got = []

        async def one(k, lane, cost):
            async with gate.slot(lanes[lane], cost):
                got.append(k)

        tasks = []
        for k, (lane, cost) in enumerate(plan):
            tasks.append(asyncio.ensure_future(one(k, lane, cost)))
            await asyncio.sleep(0)
        for _ in range(5):
            await asyncio.sleep(0)
        gate.release()
        await asyncio.gather(*tasks)
        return got

    got = asyncio.run(order(tenancy))
    assert got == asyncio.run(order(jax_tenancy))
    assert sorted(got) == list(range(len(plan)))


def test_jax_client_registers_with_the_port_multi_set_server():
    """The register/set-id path the other way: JAX clients register
    their sets with a port ``--multi-set`` filterd (two of one set share
    its engine) and get their own set's verdicts, side by side."""
    from klogs_tpu.service import client as jax_client

    lines = [b"an ERROR", b"WARN 7", b"INFO here", b"", b"WARN x"]

    async def fn(server, port):
        a = jax_client.RemoteFilterClient(f"127.0.0.1:{port}")
        b = jax_client.RemoteFilterClient(f"127.0.0.1:{port}")
        o = jax_client.RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await a.verify_patterns(["ERROR", r"WARN.*\d"])
            await b.verify_patterns(["ERROR", r"WARN.*\d"])
            await o.verify_patterns(["INFO"])
            assert a._set_id == b._set_id != o._set_id
            payload, offsets, _ = frame_lines(lines)
            got = await asyncio.gather(a.match_framed(payload, offsets),
                                       b.match(lines),
                                       o.match_framed(payload, offsets))
            return ([g if isinstance(g, list) else g.tolist() for g in got],
                    server.tenants.count, server.tenants.engine_builds)
        finally:
            for c in (a, b, o):
                await c.aclose()

    (ma, mb, mo), sets, builds = asyncio.run(_with_multi_server(
        fn, patterns=()))
    assert ma == mb == _oracle(["ERROR", r"WARN.*\d"], lines)
    assert mo == _oracle(["INFO"], lines)
    assert (sets, builds) == (2, 2)


def test_failed_engine_build_fails_the_registration():
    """A set whose engine does not build fails its own Register RPC
    (a set that does not compile: INVALID_ARGUMENT; any other build
    error reaches the caller as an error too); nothing is registered
    in its place and the other sets keep serving."""
    from klogs_tpu_torch.cluster.backend import ClusterError

    async def fn(server, port):
        real = server.tenants._filter_factory

        def failing(patterns, exclude, ignore_case):
            if patterns == ["BROKEN"]:
                raise RuntimeError("kernel build failed")
            return real(patterns, exclude, ignore_case)

        server.tenants._filter_factory = failing
        ok = RemoteFilterClient(f"127.0.0.1:{port}")
        bad = RemoteFilterClient(f"127.0.0.1:{port}")
        syntax = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await ok.verify_patterns(["FINE"])
            with pytest.raises(ClusterError, match="kernel build failed"):
                await bad.verify_patterns(["BROKEN"])
            with pytest.raises(ClusterError, match="INVALID_ARGUMENT"):
                await syntax.verify_patterns(["(unclosed"])
            assert server.tenants.fingerprints() == [ok._set_id]
            assert (await ok.match([b"FINE", b"no"])) == [True, False]
        finally:
            for c in (ok, bad, syntax):
                await c.aclose()

    asyncio.run(_with_multi_server(fn, patterns=()))


def _cache_events(registry) -> dict:
    fam = registry.family("klogs_prefilter_table_cache_events_total")
    return {dict(zip(fam.labelnames, lv))["event"]: c.value
            for lv, c in fam.children()}


def test_backend_cpu_reregistration_is_a_cache_load(tmp_path, monkeypatch):
    """--multi-set --backend cpu: an evicted indexed set registers again
    from the DFA table cache on disk (one hit per group table, no new
    miss), with the verdicts of the first build; the JAX registry does
    the same against its own cache."""
    from klogs_tpu.service import client as jax_client
    from klogs_tpu.service import server as jax_server

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    pats = ["ERROR"] + [f"svc-{i:04d} unreachable" for i in range(70)]
    lines = [b"svc-0007 unreachable", b"ERROR x", b"fine", b"svc-0099 up"]

    async def scenario(side):
        if side == "port":
            server = FilterServer([], backend="cpu", port=0, multi_set=True,
                                  metrics_port=0)
            cls = RemoteFilterClient
        else:
            server = jax_server.FilterServer([], backend="cpu", port=0,
                                             multi_set=True, metrics_port=0)
            cls = jax_client.RemoteFilterClient
        port = await server.start()
        c = cls(f"127.0.0.1:{port}")
        try:
            await c.verify_patterns(pats)
            first = await c.match(lines)
            built = _cache_events(server.registry)
            assert await server.tenants.evict(c._set_id, "idle")
            second = await c.match(lines)
            return first, second, built, _cache_events(server.registry), \
                server.tenants.engine_builds
        finally:
            await c.aclose()
            await server.stop()

    got = {side: asyncio.run(asyncio.wait_for(scenario(side), 120))
           for side in ("port", "jax")}
    first, second, built, after, builds = got["port"]
    assert first == second == [True, True, False, False]
    assert builds == 2
    assert built.get("miss", 0) > 0 and built.get("hit", 0) == 0
    assert after["miss"] == built["miss"]
    assert after["hit"] == built["miss"]
    assert got["port"][2:] == got["jax"][2:]
