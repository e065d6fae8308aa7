"""The port's sharded filterd tier (``klogs_tpu_torch/service/shard.py``).

- The contracts of the JAX ``tests/test_shard.py``, run against the
  port: endpoint-list validation, round-robin and hash routing, hedged
  dispatch with prompt loser cancellation, readiness drain, failover,
  verify-before-rejoin and quarantine, endpoint-targeted faults, and a
  fleet of three port filterds (``FilterServer(device="cpu")``, the
  kernels' plain versions) with one killed mid-stream.
- Across the packages: ``pattern_fingerprint`` and the hash ring's
  owner order equal the JAX package's over seeded pattern sets and
  fleets of 1 to 8 endpoints; a JAX ``ShardedFilterClient`` against a
  fleet of port filterds and a port one against a fleet of JAX
  ``FilterServer(backend="cpu")`` get Python ``re``'s verdicts.
"""

import asyncio

import pytest

pytest.importorskip("grpc")

import numpy as np

from klogs_tpu_torch import obs
from klogs_tpu_torch.filters.base import FilterStats
from klogs_tpu_torch.filters.sink import FilteredSink, make_pipeline
from klogs_tpu_torch.resilience import (
    FAULTS,
    BREAKER_OPEN,
    CircuitBreaker,
    FaultSpecError,
    InjectedFault,
    RetryPolicy,
    Unavailable,
)
from klogs_tpu_torch.service.client import (
    PatternMismatch,
    RemoteFilterClient,
    ServiceConfigError,
)
from klogs_tpu_torch.service.server import FilterServer
from klogs_tpu_torch.service.shard import (
    ShardedFilterClient,
    parse_endpoints,
    pattern_fingerprint,
)


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.clear()
    FAULTS.bind_registry(None)
    yield
    FAULTS.clear()
    FAULTS.bind_registry(None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's servers run the plain kernel versions in this process:
    one intra-op thread, so test workers running side by side do not
    oversubscribe the cores (a multi-threaded product per batch slows
    to a crawl when several processes do that at once)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FAST = RetryPolicy(max_attempts=2, base_s=0.005, max_s=0.01, jitter=0.0)


# ---- endpoint-list validation ----------------------------------------


def test_parse_endpoints_valid_list_trims_whitespace():
    assert parse_endpoints("a:1, b:2 ,unix:/tmp/fd.sock") == [
        "a:1", "b:2", "unix:/tmp/fd.sock"]


@pytest.mark.parametrize("spec,needle", [
    ("a:1,,b:2", "empty entry"),
    (" ", "empty entry"),
    ("a:1,a:1", "'a:1' more than once"),
    ("hostonly", "'hostonly'"),
    ("h:0", "bad port '0'"),
    ("h:99999", "bad port '99999'"),
    ("h:xx", "bad port 'xx'"),
    ("unix:", "empty unix socket path"),
])
def test_parse_endpoints_rejects_bad_entries_naming_them(spec, needle):
    with pytest.raises(ServiceConfigError) as ei:
        parse_endpoints(spec)
    assert needle in str(ei.value)


def test_make_pipeline_validates_remote_list_at_startup():
    with pytest.raises(ServiceConfigError, match="more than once"):
        make_pipeline(["x"], remote="127.0.0.1:1,127.0.0.1:1")
    with pytest.raises(ServiceConfigError, match="bad port"):
        make_pipeline(["x"], remote="127.0.0.1:1,other:nope")


def test_make_pipeline_single_endpoint_uses_plain_client():
    """One target = the plain client (no hedge machinery, no prober);
    a list = the sharded tier. Built inside a loop: grpc.aio
    channels (both client flavors) require one at construction."""
    async def scenario():
        p = make_pipeline(["x"], remote="127.0.0.1:1")
        assert type(p.service) is RemoteFilterClient
        await p.service.aclose()
        p2 = make_pipeline(["x"], remote="127.0.0.1:1,127.0.0.2:1")
        assert type(p2.service) is ShardedFilterClient
        await p2.service.aclose()

    run(scenario())


@pytest.mark.parametrize("bad", ["-1", "0", "nan", "inf", "soon"])
def test_make_pipeline_rejects_bad_hedge_env(monkeypatch, bad):
    monkeypatch.setenv("KLOGS_HEDGE_S", bad)
    with pytest.raises(ServiceConfigError, match="KLOGS_HEDGE_S"):
        make_pipeline(["x"], remote="127.0.0.1:1,127.0.0.2:1")


def test_construction_without_an_event_loop():
    """make_pipeline runs at CLI startup, BEFORE any event loop exists
    — and on Python 3.10 an eager asyncio primitive in the constructor
    blows up once a previous asyncio.run() has cleared the thread's
    loop. Construction must be loop-free (regression: the prober stop
    event is created lazily inside the loop)."""
    asyncio.set_event_loop(None)  # the state a prior asyncio.run leaves
    sc = ShardedFilterClient(["a:1", "b:1"], client_factory=FakeClient)
    assert sc._probe_stop is None

    async def scenario():
        got = await sc.match([b"x"])
        await sc.aclose()
        return got

    assert run(scenario()) == ["a:1"]


def test_unknown_shard_mode_rejected():
    with pytest.raises(ServiceConfigError, match="shard-mode"):
        ShardedFilterClient(["a:1", "b:1"], shard_mode="random",
                            client_factory=FakeClient)


# ---- fakes -----------------------------------------------------------


class FakeClient:
    """Duck-typed stand-in for RemoteFilterClient: answers with its own
    target so routing tests can see who won, counts cancellations so
    hedge tests can prove the loser died promptly."""

    def __init__(self, target, *, fail=False, delay_s=0.0):
        self.target = target
        self.breaker = CircuitBreaker(
            name=f"rpc@{target}", failure_threshold=2,
            reset_timeout_s=60.0)
        self.fail = fail
        self.delay_s = delay_s
        self.calls = 0
        self.cancelled = 0
        self.closed = False

    async def _op(self):
        self.calls += 1
        try:
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
        except asyncio.CancelledError:
            self.cancelled += 1
            raise
        if self.fail:
            self.breaker.record_failure()
            raise Unavailable(f"filter service at {self.target}: down")
        self.breaker.record_success()
        return [self.target]

    async def hello(self):
        await self._op()
        return {"patterns": ["ERROR"], "exclude": [],
                "ignore_case": False, "framed": True}

    async def match(self, lines):
        return await self._op()

    async def match_framed(self, payload, offsets):
        return await self._op()

    async def aclose(self):
        self.closed = True

    def close(self):
        self.closed = True


class MaskFakeClient(FakeClient):
    """Returns real keep-everything masks so FilteredSink can consume
    the result (degrade-routing tests)."""

    async def match(self, lines):
        await self._op()
        return [True] * len(lines)

    async def match_framed(self, payload, offsets):
        await self._op()
        return np.ones(len(offsets) - 1, dtype=bool)


class CaptureSink:
    def __init__(self):
        self.data = b""
        self.bytes_written = 0

    async def write(self, b):
        self.data += b
        self.bytes_written += len(b)

    async def flush(self):
        pass

    async def close(self):
        pass


# ---- routing ---------------------------------------------------------


def test_round_robin_rotates_per_batch():
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t)
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1", "c:1"], hedge_s=None,
                             client_factory=factory)

    async def scenario():
        got = [(await sc.match([b"x"]))[0] for _ in range(6)]
        await sc.aclose()
        return got

    assert run(scenario()) == ["a:1", "b:1", "c:1", "a:1", "b:1", "c:1"]
    assert all(c.closed for c in clients.values())


def test_hash_mode_pins_one_owner():
    def owner_for(fp):
        sc = ShardedFilterClient(
            ["a:1", "b:1", "c:1"], shard_mode="hash", fingerprint=fp,
            hedge_s=None, client_factory=FakeClient)
        return sc._natural_order()[0].target

    fp = pattern_fingerprint(["ERROR"], [], False)
    # Deterministic: same fingerprint, same owner, every time.
    assert owner_for(fp) == owner_for(fp)

    sc = ShardedFilterClient(["a:1", "b:1", "c:1"], shard_mode="hash",
                             fingerprint=fp, hedge_s=None,
                             client_factory=FakeClient)

    async def scenario():
        got = [(await sc.match([b"x"]))[0] for _ in range(5)]
        await sc.aclose()
        return got

    got = run(scenario())
    assert len(set(got)) == 1 and got[0] == owner_for(fp)


def test_consistent_hash_moves_only_the_lost_owners_keys():
    """Removing one endpoint re-homes ONLY the keys it owned — the
    property that makes hash mode safe under fleet churn."""
    keys = [f"fp{i}" for i in range(64)]

    def owners(targets):
        out = {}
        for k in keys:
            sc = ShardedFilterClient(targets, shard_mode="hash",
                                     fingerprint=k, hedge_s=None,
                                     client_factory=FakeClient)
            out[k] = sc._natural_order()[0].target
        return out

    full = owners(["a:1", "b:1", "c:1"])
    assert len(set(full.values())) == 3, "vnodes failed to spread owners"
    shrunk = owners(["b:1", "c:1"])
    for k in keys:
        if full[k] != "a:1":
            assert shrunk[k] == full[k], "an unrelated key moved"


def test_hash_owner_down_fails_over_to_ring_successor():
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t)
        return clients[t]

    fp = "some-fingerprint"
    sc = ShardedFilterClient(["a:1", "b:1", "c:1"], shard_mode="hash",
                             fingerprint=fp, hedge_s=None,
                             client_factory=factory)
    natural = [ep.target for ep in sc._natural_order()]
    owner, successor = natural[0], natural[1]
    clients[owner].fail = True

    async def scenario():
        # Two failing dispatches trip the owner's breaker (threshold 2
        # in the fake, one failure recorded per dispatch attempt)...
        got = [(await sc.match([b"x"]))[0] for _ in range(4)]
        await sc.aclose()
        return got

    got = run(scenario())
    # Every batch was answered by the ring successor, none dropped.
    assert got == [successor] * 4
    # ...and once open, the owner is demoted: no more wire attempts.
    assert clients[owner].breaker.state == BREAKER_OPEN
    assert clients[owner].calls == 2


def test_unready_endpoint_routed_around_and_rejoins():
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t)
        return clients[t]

    registry = obs.Registry()
    obs.register_all(registry)
    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             registry=registry, client_factory=factory)

    async def scenario():
        sc._set_ready(sc._endpoints[1], False)  # prober verdict: draining
        drained = [(await sc.match([b"x"]))[0] for _ in range(4)]
        calls_while_drained = clients["b:1"].calls
        sc._set_ready(sc._endpoints[1], True)
        rejoined = [(await sc.match([b"x"]))[0] for _ in range(4)]
        await sc.aclose()
        return drained, calls_while_drained, rejoined

    drained, calls_while_drained, rejoined = run(scenario())
    assert drained == ["a:1"] * 4, "a draining endpoint was routed to"
    assert calls_while_drained == 0
    assert set(rejoined) == {"a:1", "b:1"}, "recovered endpoint not rejoined"
    ready = registry.family("klogs_shard_endpoint_ready")
    assert ready.labels(endpoint="b:1").value == 1
    reroutes = registry.family("klogs_shard_reroutes_total")
    assert reroutes.labels(endpoint="b:1", reason="unready").value > 0


# ---- hedged dispatch -------------------------------------------------


def test_hedge_races_slow_primary_loser_cancelled_no_leaked_tasks():
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t, delay_s=5.0 if t == "a:1" else 0.0)
        return clients[t]

    registry = obs.Registry()
    obs.register_all(registry)
    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=0.02,
                             registry=registry, client_factory=factory)

    async def scenario():
        before = asyncio.all_tasks()
        got = await sc.match([b"x"])
        after = asyncio.all_tasks()
        await sc.aclose()
        return got, before, after

    got, before, after = run(scenario())
    assert got == ["b:1"], "hedge winner's verdicts were not used"
    # The losing hedged RPC was cancelled promptly and awaited — no
    # orphan task survives the dispatch.
    assert clients["a:1"].cancelled == 1
    assert after - before == set(), f"leaked tasks: {after - before}"
    hedges = registry.family("klogs_shard_hedges_total")
    assert hedges.labels(endpoint="b:1").value == 1
    batches = registry.family("klogs_shard_batches_total")
    # Exactly ONE batch counted, for the winner only (the loser must
    # never double-count).
    assert batches.labels(endpoint="b:1").value == 1
    assert batches.labels(endpoint="a:1").value == 0


def test_single_endpoint_no_hedge_tasks_same_verdicts():
    """A one-endpoint shard client behaves like the plain client: one
    attempt, no hedge/prober tasks, identical verdict shape."""
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t)
        return clients[t]

    sc = ShardedFilterClient(["a:1"], hedge_s=0.01, client_factory=factory)

    async def scenario():
        before = asyncio.all_tasks()
        got = await sc.match([b"x"])
        after = asyncio.all_tasks()
        await sc.aclose()
        return got, before, after

    got, before, after = run(scenario())
    assert got == ["a:1"] and clients["a:1"].calls == 1
    assert after - before == set()


def test_outer_cancellation_tears_down_all_inflight_attempts():
    """Cancelling a dispatch mid-hedge (the deadline-flusher-cancel
    path) must cancel BOTH in-flight attempts — nothing keeps running
    against the fleet after the caller gave up."""
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t, delay_s=30.0)
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=0.02,
                             client_factory=factory)

    async def scenario():
        task = asyncio.create_task(sc.match([b"x"]))
        await asyncio.sleep(0.1)  # primary + hedge both in flight
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        leaked = [t for t in asyncio.all_tasks()
                  if t is not asyncio.current_task()]
        await sc.aclose()
        return leaked

    leaked = run(scenario())
    assert leaked == []
    assert all(c.cancelled == 1 for c in clients.values())


def test_failover_exhaustion_raises_unavailable_naming_everyone():
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t, fail=True)
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             client_factory=factory)

    async def scenario():
        try:
            with pytest.raises(Unavailable) as ei:
                await sc.match([b"x"])
            return str(ei.value)
        finally:
            await sc.aclose()

    msg = run(scenario())
    assert "all 2 filterd endpoint(s) unavailable" in msg
    assert "a:1" in msg and "b:1" in msg


# ---- degrade only when ALL endpoints are down ------------------------


def test_sink_does_not_degrade_while_one_endpoint_survives():
    clients = {}

    def factory(t):
        clients[t] = MaskFakeClient(t, fail=(t == "a:1"))
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             client_factory=factory)
    stats = FilterStats()
    inner = CaptureSink()
    sink = FilteredSink(inner, sc, stats, on_filter_error="pass")

    async def scenario():
        await sink.write(b"one\ntwo\nthree\nfour\n")
        await sink.close()
        await sc.aclose()

    run(scenario())
    assert inner.data == b"one\ntwo\nthree\nfour\n"
    assert stats._degraded_batches.labels(action="pass").value == 0, \
        "partial-fleet failure must reroute, not degrade"


def test_sink_degrades_only_when_whole_fleet_is_down():
    clients = {}

    def factory(t):
        clients[t] = MaskFakeClient(t, fail=True)
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             client_factory=factory)
    stats = FilterStats()
    inner = CaptureSink()
    sink = FilteredSink(inner, sc, stats, on_filter_error="pass")

    async def scenario():
        await sink.write(b"one\ntwo\nthree\nfour\n")
        await sink.close()
        await sc.aclose()

    run(scenario())
    # pass-mode: the batch rode through UNFILTERED, counted as degraded.
    assert inner.data == b"one\ntwo\nthree\nfour\n"
    assert stats._degraded_batches.labels(action="pass").value == 1


# ---- verify_patterns over a fleet ------------------------------------


def test_verify_patterns_mismatched_shard_fails_the_run():
    class DriftedClient(FakeClient):
        async def hello(self):
            await self._op()
            return {"patterns": ["different"], "exclude": [],
                    "ignore_case": False}

    def factory(t):
        return (DriftedClient if t == "b:1" else FakeClient)(t)

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             client_factory=factory)

    async def scenario():
        try:
            with pytest.raises(PatternMismatch, match="b:1"):
                await sc.verify_patterns(["ERROR"])
        finally:
            await sc.aclose()

    run(scenario())


def test_verify_patterns_survives_a_down_endpoint(capsys):
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t, fail=(t == "a:1"))
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             client_factory=factory)

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        await sc.aclose()

    run(scenario())
    out = capsys.readouterr().out
    assert "a:1" in out and "unavailable at startup" in out


def test_endpoint_down_at_startup_is_excluded_then_verified_on_return():
    """An endpoint unreachable during the startup handshake must not
    receive a single batch (its pattern set is unproven) — and when it
    comes back with a MATCHING set, the background prober verifies it
    and it joins the rotation."""
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t, fail=(t == "b:1"))
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             probe_interval_s=0.02,
                             client_factory=factory)

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        assert sc._endpoints[1].verified is False
        assert sc._probe_task is not None, \
            "prober must run to re-verify the down endpoint"
        hellos_at_start = clients["b:1"].calls
        got = [(await sc.match([b"x"]))[0] for _ in range(4)]
        assert got == ["a:1"] * 4, "unverified endpoint got traffic"
        # Only hello probes ever reached b — no match dispatches.
        clients["b:1"].fail = False  # b comes back, same pattern set
        for _ in range(100):
            if sc._endpoints[1].verified:
                break
            await asyncio.sleep(0.02)
        assert sc._endpoints[1].verified, "recovered endpoint not verified"
        assert clients["b:1"].calls > hellos_at_start
        got2 = [(await sc.match([b"x"]))[0] for _ in range(4)]
        await sc.aclose()
        return got2

    got2 = run(asyncio.wait_for(scenario(), timeout=20))
    assert "b:1" in got2, "verified endpoint never rejoined the rotation"


def test_drifted_late_rejoin_is_quarantined(capsys):
    """The dangerous rejoin: the endpoint that was down at startup
    comes back serving a DIFFERENT pattern set (redeploy drift). It
    must be permanently quarantined with one loud error — never routed
    a batch it would mis-filter."""
    class DriftedOnRecovery(FakeClient):
        async def hello(self):
            await self._op()
            return {"patterns": ["different"], "exclude": [],
                    "ignore_case": False}

    clients = {}

    def factory(t):
        cls = DriftedOnRecovery if t == "b:1" else FakeClient
        clients[t] = cls(t, fail=(t == "b:1"))
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             probe_interval_s=0.02,
                             client_factory=factory)

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        clients["b:1"].fail = False  # back up — but drifted
        for _ in range(100):
            if sc._endpoints[1].quarantined:
                break
            await asyncio.sleep(0.02)
        assert sc._endpoints[1].quarantined
        match_calls_before = clients["b:1"].calls
        got = [(await sc.match([b"x"]))[0] for _ in range(4)]
        assert got == ["a:1"] * 4
        assert clients["b:1"].calls == match_calls_before, \
            "a quarantined endpoint was dispatched to"
        await sc.aclose()

    run(asyncio.wait_for(scenario(), timeout=20))
    assert "DRIFTED" in capsys.readouterr().out


def test_midrun_redeploy_with_drifted_patterns_is_quarantined(capsys):
    """The hardest drift window: an endpoint that was healthy and
    verified at startup goes down mid-run (breaker opens) and comes
    back REDEPLOYED with a different pattern set. Opening the breaker
    demotes it to unverified, so the prober re-runs the handshake and
    quarantines it — it must never be trusted again on the old
    verification."""
    class RedeployedClient(FakeClient):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.drifted = False

        async def hello(self):
            await self._op()
            return {"patterns": ["different" if self.drifted else "ERROR"],
                    "exclude": [], "ignore_case": False}

    clients = {}

    def factory(t):
        cls = RedeployedClient if t == "b:1" else FakeClient
        clients[t] = cls(t)
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             probe_interval_s=0.02,
                             client_factory=factory)

    async def scenario():
        await sc.verify_patterns(["ERROR"])  # both healthy + verified
        b = clients["b:1"]
        b.fail = True  # the server goes down (redeploy in progress)
        # Keep dispatching until b's breaker opens (threshold 2 in the
        # fake): every batch still resolves on a.
        for _ in range(6):
            assert (await sc.match([b"x"])) == ["a:1"]
        assert sc._endpoints[1].verified is False, \
            "breaker opening must force re-verification"
        b.fail = False
        b.drifted = True  # ...and it comes back with different patterns
        for _ in range(100):
            if sc._endpoints[1].quarantined:
                break
            await asyncio.sleep(0.02)
        assert sc._endpoints[1].quarantined
        for _ in range(4):
            assert (await sc.match([b"x"])) == ["a:1"]
        await sc.aclose()

    run(asyncio.wait_for(scenario(), timeout=20))
    assert "DRIFTED" in capsys.readouterr().out


def test_learn_readyz_host_resolution():
    """The sidecar is only probed where it is actually reachable: a
    loopback-bound sidecar on a remote node is skipped (a refused probe
    would wrongly demote a healthy server), a wildcard bind is probed
    at the gRPC host, an explicit bind at its own address."""
    sc = ShardedFilterClient(["10.0.0.5:50051", "127.0.0.1:50051"],
                             hedge_s=None, client_factory=FakeClient)
    remote_ep, local_ep = sc._endpoints
    sc._learn_readyz(remote_ep,
                     {"metrics_port": 9100, "metrics_host": "127.0.0.1"})
    assert remote_ep.readyz is None  # unreachable loopback: skipped
    sc._learn_readyz(remote_ep,
                     {"metrics_port": 9100, "metrics_host": "0.0.0.0"})
    assert remote_ep.readyz == ("10.0.0.5", 9100)
    sc._learn_readyz(remote_ep,
                     {"metrics_port": 9100, "metrics_host": "10.0.0.99"})
    assert remote_ep.readyz == ("10.0.0.99", 9100)
    sc._learn_readyz(local_ep,
                     {"metrics_port": 9100, "metrics_host": "127.0.0.1"})
    assert local_ep.readyz == ("127.0.0.1", 9100)  # co-located: probed
    remote_ep.readyz = None
    sc._learn_readyz(remote_ep, {"metrics_port": 9100})
    assert remote_ep.readyz is None  # old server: conservative default


def test_verify_patterns_handshakes_concurrently():
    """Startup pays the MAX of the per-endpoint hello towers, not the
    sum — a slow or black-holing endpoint must not serialize the whole
    fleet's startup behind it."""
    import time as _time

    def factory(t):
        return FakeClient(t, delay_s=0.4)

    sc = ShardedFilterClient(["a:1", "b:1", "c:1"], hedge_s=None,
                             client_factory=factory)

    async def scenario():
        t0 = _time.perf_counter()
        await sc.verify_patterns(["ERROR"])
        elapsed = _time.perf_counter() - t0
        await sc.aclose()
        return elapsed

    elapsed = run(asyncio.wait_for(scenario(), timeout=20))
    assert elapsed < 0.9, \
        f"three 0.4s hellos took {elapsed:.2f}s — serialized, not gathered"


def test_verify_patterns_all_down_is_a_hard_error():
    def factory(t):
        return FakeClient(t, fail=True)

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             client_factory=factory)

    async def scenario():
        try:
            with pytest.raises(Unavailable, match="no filterd endpoint"):
                await sc.verify_patterns(["ERROR"])
        finally:
            await sc.aclose()

    run(scenario())


# ---- endpoint-targeted faults ----------------------------------------


def test_targeted_fault_fires_only_for_its_endpoint():
    FAULTS.load_spec("rpc.match@h:1:error*2")

    async def scenario():
        await FAULTS.fire("rpc.match", "h:2")   # someone else's server
        await FAULTS.fire("rpc.match", None)    # untargeted site
        with pytest.raises(InjectedFault):
            await FAULTS.fire("rpc.match", "h:1")

    run(scenario())
    assert FAULTS.counts == {"rpc.match@h:1": 1}


def test_untargeted_rule_still_fires_everywhere():
    FAULTS.load_spec("rpc.match:error*2")

    async def scenario():
        for target in ("h:1", "h:2"):
            with pytest.raises(InjectedFault):
                await FAULTS.fire("rpc.match", target)

    run(scenario())
    assert FAULTS.counts == {"rpc.match": 2}


def test_targeted_spec_unknown_point_rejected():
    with pytest.raises(FaultSpecError, match="unknown fault point"):
        FAULTS.load_spec("nope@h:1:error")


@pytest.mark.parametrize("spec", [
    "rpc.match@hostonly:error",      # no port
    "rpc.match@h:99999:error",       # port out of range
    "rpc.match@h:0:error*2",         # port zero
    "rpc.match@unix::error",         # empty unix path
])
def test_targeted_spec_malformed_target_rejected(spec):
    """A malformed target can never equal any endpoint fire() passes —
    the clause would be a chaos script that silently tests nothing."""
    with pytest.raises(FaultSpecError, match="bad fault target"):
        FAULTS.load_spec(spec)


def test_targeted_spec_absent_endpoint_warns_at_pipeline_build(capsys):
    """Well-formed but wrong (one typoed digit): caught by the fleet
    cross-check when the pipeline is built."""
    FAULTS.load_spec("rpc.match@127.0.0.1:5051:error*")

    async def scenario():
        p = make_pipeline(["x"], remote="127.0.0.1:50051,127.0.0.1:50052")
        await p.service.aclose()

    run(scenario())
    out = capsys.readouterr().out
    assert "127.0.0.1:5051" in out and "never fire" in out


def test_blackholed_endpoint_does_not_stall_the_prober():
    """An unverified endpoint whose handshake black-holes (no fast
    refusal) must not stall the sequential probe loop: the late-verify
    hello is bounded by the probe timeout, so when the endpoint finally
    answers it is verified promptly rather than minutes later."""
    clients = {}

    def factory(t):
        clients[t] = FakeClient(t, fail=(t == "b:1"))
        return clients[t]

    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             probe_interval_s=0.02, probe_timeout_s=0.05,
                             client_factory=factory)

    async def scenario():
        await sc.verify_patterns(["ERROR"])
        b = clients["b:1"]
        b.fail = False
        b.delay_s = 30.0  # black hole: hello hangs, never refuses
        await asyncio.sleep(0.3)  # several probe cycles elapse
        assert sc._endpoints[1].verified is False
        assert b.cancelled >= 1, "late-verify hello was not bounded"
        b.delay_s = 0.0  # node recovers
        for _ in range(100):
            if sc._endpoints[1].verified:
                break
            await asyncio.sleep(0.02)
        assert sc._endpoints[1].verified
        await sc.aclose()

    run(asyncio.wait_for(scenario(), timeout=20))


def test_arm_with_target_skips_other_endpoints():
    FAULTS.arm("rpc.match", target="h:1", exc=InjectedFault("x"),
               times=None)

    async def scenario():
        await FAULTS.fire("rpc.match", "h:2")  # no-op
        with pytest.raises(InjectedFault):
            await FAULTS.fire("rpc.match", "h:1")

    run(scenario())


# ---- kill one of 3, drain + rejoin -----------------------------------


def _server_factory(registry):
    def factory(t):
        return RemoteFilterClient(
            t, retry=FAST, rpc_timeout_s=5.0,
            breaker=CircuitBreaker(name=f"rpc@{t}", failure_threshold=2,
                                   reset_timeout_s=30.0,
                                   registry=registry),
            registry=registry)
    return factory


def test_chaos_kill_one_of_three_mid_stream():
    """The headline scenario: a 3-endpoint fleet, one killed mid-stream
    via an endpoint-targeted KLOGS_FAULTS-style spec. Aggregate
    matching continues on the survivors with zero dropped batches, the
    dead endpoint's breaker opens exactly once (no flapping — no
    further wire attempts once open), and degrade never fires."""
    registry = obs.Registry()
    obs.register_all(registry)
    FAULTS.bind_registry(registry)
    lines = [b"an ERROR", b"ok line"]

    async def scenario():
        servers = [FilterServer(["ERROR"], device="cpu", port=0)
                   for _ in range(3)]
        ports = [await s.start() for s in servers]
        targets = [f"127.0.0.1:{p}" for p in ports]
        sc = ShardedFilterClient(targets, registry=registry, hedge_s=0.2,
                                 client_factory=_server_factory(registry))
        try:
            await sc.verify_patterns(["ERROR"])
            victim = targets[1]
            results = []
            for i in range(8):
                if i == 3:  # kill exactly one server mid-stream
                    FAULTS.load_spec(f"rpc.match@{victim}:error*")
                results.append(await sc.match(lines))
            return targets, victim, results
        finally:
            await sc.aclose()
            for s in servers:
                await s.stop()

    targets, victim, results = run(asyncio.wait_for(scenario(), timeout=30))
    # Zero dropped batches, verdicts correct throughout the outage.
    assert results == [[True, False]] * 8
    # The breaker opened ONCE: exactly threshold (2) wire attempts hit
    # the dead endpoint, then it was demoted — no flapping, no further
    # injected-fault firings.
    assert FAULTS.counts == {f"rpc.match@{victim}": 2}
    text = obs.render(registry)
    assert f'klogs_breaker_state{{breaker="rpc@{victim}"}} 1' in text
    # Survivors absorbed every batch: per-endpoint wins sum to 8 and
    # the victim stopped winning after the kill.
    batches = registry.family("klogs_shard_batches_total")
    per_ep = {t: batches.labels(endpoint=t).value for t in targets}
    assert sum(per_ep.values()) == 8
    assert per_ep[victim] == 1  # its one pre-kill round-robin win
    # Endpoint-labeled retry series for the victim exists.
    assert f'klogs_retry_attempts_total{{site="rpc@{victim}"}}' in text


def test_readyz_drain_and_rejoin():
    """A server whose /readyz stops answering 200 (drain/rolling
    restart) is routed around BEFORE any RPC fails — zero errors, zero
    batches routed to it — and rejoins the rotation once /readyz
    recovers."""
    registry = obs.Registry()
    obs.register_all(registry)

    async def scenario():
        servers = [FilterServer(["ERROR"], device="cpu", port=0,
                                metrics_port=0) for _ in range(2)]
        ports = [await s.start() for s in servers]
        targets = [f"127.0.0.1:{p}" for p in ports]
        sc = ShardedFilterClient(targets, registry=registry, hedge_s=None,
                                 probe_interval_s=0.03,
                                 client_factory=_server_factory(registry))
        batches = registry.family("klogs_shard_batches_total")
        try:
            await sc.verify_patterns(["ERROR"])
            assert sc._probe_task is not None, \
                "prober did not start despite advertised metrics ports"
            # Both servers warm up (readiness flips on the warmup
            # batch); wait until the prober has seen them ready.
            async def until(pred):
                # 15s budget (scenario cap is 30s): a loaded CI box can
                # stall the 0.03s prober well past the transition point.
                for _ in range(300):
                    if pred():
                        return True
                    await asyncio.sleep(0.05)
                return False

            def state():
                t = sc._probe_task
                return (
                    [(ep.target, ep.ready, ep.verified, ep.quarantined,
                      ep.readyz) for ep in sc._endpoints],
                    [(s.metrics_host, s.metrics_port, s.health._ready)
                     for s in servers],
                    None if t is None else
                    (t.done(), t.exception() if t.done()
                     and not t.cancelled() else None),
                )

            # Wait for the warmup batches to actually land (ep.ready
            # defaults True, so the prober's view alone cannot prove
            # warmth): draining before warmup completes exercises the
            # mark_warm latch path, not the rejoin path under test.
            assert await until(
                lambda: all(s.health._ready for s in servers)), state()
            assert await until(
                lambda: all(ep.ready for ep in sc._endpoints)), state()
            # Drain server B: readiness off, gRPC still serving.
            servers[1].health.set_ready(False)
            assert await until(
                lambda: not sc._endpoints[1].ready), state()
            before_b = batches.labels(endpoint=targets[1]).value
            for _ in range(4):
                assert await sc.match([b"an ERROR", b"ok"]) == [True, False]
            # Routed around BEFORE any RPC could fail: no batch went to
            # the draining server, none was dropped.
            assert batches.labels(endpoint=targets[1]).value == before_b
            # Recover: /readyz answers 200 again, B rejoins.
            servers[1].health.set_ready(True)
            assert await until(lambda: sc._endpoints[1].ready)
            for _ in range(4):
                assert await sc.match([b"an ERROR", b"ok"]) == [True, False]
            assert batches.labels(endpoint=targets[1]).value > before_b
        finally:
            await sc.aclose()
            for s in servers:
                await s.stop()

    run(asyncio.wait_for(scenario(), timeout=30))


def test_soak_rolling_restart_under_load(tmp_path):
    """Multi-server chaos soak: a 3-server fleet under a continuous
    batch stream; one server is HARD-killed (process-level stop, real
    UNAVAILABLE errors, not injected faults), later restarted on the
    same port. Zero dropped batches across the whole timeline, and the
    restarted server rejoins via its breaker's half-open probe."""
    registry = obs.Registry()
    obs.register_all(registry)

    def factory(t):
        return RemoteFilterClient(
            t, retry=FAST, rpc_timeout_s=2.0,
            breaker=CircuitBreaker(name=f"rpc@{t}", failure_threshold=2,
                                   reset_timeout_s=1.0,
                                   registry=registry),
            registry=registry)

    async def scenario():
        servers = [FilterServer(["ERROR"], device="cpu", port=0)
                   for _ in range(3)]
        ports = [await s.start() for s in servers]
        targets = [f"127.0.0.1:{p}" for p in ports]
        sc = ShardedFilterClient(targets, registry=registry, hedge_s=0.3,
                                 client_factory=factory)
        batches = registry.family("klogs_shard_batches_total")
        restarted = None
        try:
            await sc.verify_patterns(["ERROR"])
            victim_i = 1
            victim = targets[victim_i]
            wins_at_restart = 0.0
            for i in range(150):
                if i == 30:
                    await servers[victim_i].stop(grace=0)
                if i == 60:
                    restarted = FilterServer(
                        ["ERROR"], device="cpu",
                        port=ports[victim_i])
                    await restarted.start()
                    wins_at_restart = batches.labels(
                        endpoint=victim).value
                got = await sc.match([b"an ERROR", b"fine"])
                assert got == [True, False], f"batch {i} wrong"
                await asyncio.sleep(0.025)
            # The restarted server rejoined: its breaker half-opened
            # after reset_timeout, the probe dispatch succeeded, and it
            # won batches again in the final stretch.
            assert batches.labels(endpoint=victim).value \
                > wins_at_restart, "restarted server never rejoined"
            per_ep = {t: batches.labels(endpoint=t).value
                      for t in targets}
            assert sum(per_ep.values()) == 150
            text = obs.render(registry)
            assert f'klogs_breaker_state{{breaker="rpc@{victim}"}} 0' \
                in text, "restarted server's breaker did not re-close"
        finally:
            await sc.aclose()
            for s in servers[:victim_i] + servers[victim_i + 1:]:
                await s.stop()
            if restarted is not None:
                await restarted.stop()

    run(asyncio.wait_for(scenario(), timeout=120))


# ---- across the packages ------------------------------------------------


def _seeded_set(rng):
    """A pattern set with exclude patterns, unicode and regex syntax."""
    alphabet = ["ERROR", "WARN", r"\d+", ".*", "é", "日志", "x|y", "[a-f]",
                "code=5\\d\\d", " ", "\x00"]

    def pat():
        return "".join(rng.choice(alphabet)
                       for _ in range(rng.randrange(1, 4)))

    return ([pat() for _ in range(rng.randrange(1, 6))],
            [pat() for _ in range(rng.randrange(0, 3))],
            rng.random() < 0.5)


@pytest.mark.parametrize("n_endpoints", range(1, 9))
def test_fingerprint_and_ring_order_equal_jax(n_endpoints):
    """200 seeded pattern sets: the same set id, and the same ring walk
    (owner first, then the failover order) over the same fleet of
    ``n_endpoints``, as the JAX package's."""
    import random

    from klogs_tpu.service import shard as jax_shard

    rng = random.Random(1000 + n_endpoints)
    for _ in range(200):
        pats, excl, ic = _seeded_set(rng)
        fp = pattern_fingerprint(pats, excl, ic)
        assert fp == jax_shard.pattern_fingerprint(pats, excl, ic)
        targets = [f"10.{rng.randrange(256)}.0.{i}:{rng.randrange(1, 65536)}"
                   for i in range(n_endpoints)]
        orders = []
        for cls in (ShardedFilterClient, jax_shard.ShardedFilterClient):
            sc = cls(targets, shard_mode="hash", fingerprint=fp,
                     hedge_s=None, client_factory=lambda t: object())
            orders.append([targets[i] for i in sc._hash_order])
        assert orders[0] == orders[1]
        assert sorted(orders[0]) == sorted(targets)


def _oracle(patterns, lines):
    import re

    rx = [re.compile(p.encode()) for p in patterns]
    return [any(r.search(ln.rstrip(b"\n")) for r in rx) for ln in lines]


def _lines(seed: int, n: int) -> list:
    import random

    rng = random.Random(seed)
    words = [b"ERROR", b"WARN", b"INFO", b"code", b"7", b"x", b""]
    return [b" ".join(rng.choice(words) for _ in range(rng.randrange(6)))
            for _ in range(n)]


@pytest.mark.parametrize("multi_set", [False, True],
                         ids=["single_set", "multi_set"])
@pytest.mark.parametrize("mode", ["round-robin", "hash"])
@pytest.mark.parametrize("direction", ["jax_client_port_fleet",
                                       "port_client_jax_fleet"])
def test_sharded_client_across_packages(direction, mode, multi_set):
    """A fleet of three filterds of one package behind the other
    package's ShardedFilterClient: every batch's verdicts equal ``re``'s
    (framed and per-line), every batch is counted once, under
    round-robin every endpoint served and under hash one owner did.
    Multi-set fleets register the collector's set on each endpoint."""
    from klogs_tpu import obs as jax_obs
    from klogs_tpu.service import server as jax_server
    from klogs_tpu.service import shard as jax_shard
    from klogs_tpu_torch.filters.base import frame_lines

    pats = ["ERROR", r"WARN.*\d"]
    served = [] if multi_set else pats
    lines = _lines(7, 200)

    async def scenario():
        if direction == "jax_client_port_fleet":
            servers = [FilterServer(served, device="cpu", port=0,
                                    multi_set=multi_set) for _ in range(3)]
            reg = jax_obs.Registry()
            jax_obs.register_all(reg)
            client_cls = jax_shard.ShardedFilterClient
            fp = jax_shard.pattern_fingerprint(pats, [], False)
        else:
            servers = [jax_server.FilterServer(served, backend="cpu", port=0,
                                               multi_set=multi_set)
                       for _ in range(3)]
            reg = obs.Registry()
            obs.register_all(reg)
            client_cls = ShardedFilterClient
            fp = pattern_fingerprint(pats, [], False)
        ports = [await s.start() for s in servers]
        targets = [f"127.0.0.1:{p}" for p in ports]
        sc = client_cls(targets, shard_mode=mode, fingerprint=fp,
                        hedge_s=None, registry=reg)
        try:
            await sc.verify_patterns(pats, False, exclude=[])
            got = []
            for i in range(6):
                chunk = lines[i * 30:(i + 1) * 30]
                payload, offsets, _ = frame_lines(chunk, strip_nl=False)
                got.append(((await sc.match_framed(payload, offsets))
                            .tolist(), chunk))
                got.append((await sc.match(chunk), chunk))
            fam = reg.family("klogs_shard_batches_total")
            wins = {t: fam.labels(endpoint=t).value for t in targets}
            sets = [s.tenants.count for s in servers] if multi_set else []
            return got, wins, sets
        finally:
            await sc.aclose()
            for s in servers:
                await s.stop()

    got, wins, sets = run(asyncio.wait_for(scenario(), timeout=60))
    for mask, chunk in got:
        assert mask == _oracle(["ERROR", r"WARN.*\d"], chunk)
    assert sum(wins.values()) == 12
    if mode == "hash":
        assert sorted(wins.values()) == [0, 0, 12]
    else:
        assert all(v > 0 for v in wins.values())
    assert sets == ([1, 1, 1] if multi_set else [])


def test_attempt_on_a_retired_endpoint_fails_over():
    """A membership change retires an endpoint while a batch's attempt
    is in flight there, and its closed channel fails the attempt with a
    non-transient error (grpc's UsageError on a closed channel): the
    batch fails over to the fleet as it is now, and no series is made
    again for the leaver. (The JAX tier propagates the error, ending
    the run.)"""

    class ClosingClient(FakeClient):
        def __init__(self, target, **kw):
            super().__init__(target, **kw)
            self.entered = asyncio.Event()
            self.gone = asyncio.Event()

        async def match(self, lines):
            self.calls += 1
            self.entered.set()
            await self.gone.wait()
            raise RuntimeError("Channel is closed.")

        async def aclose(self):
            self.closed = True
            self.gone.set()

    clients = {}

    def factory(t):
        clients[t] = (ClosingClient if t == "a:1" else FakeClient)(t)
        return clients[t]

    registry = obs.Registry()
    obs.register_all(registry)
    sc = ShardedFilterClient(["a:1", "b:1"], hedge_s=None,
                             registry=registry, client_factory=factory)

    async def scenario():
        task = asyncio.ensure_future(sc.match([b"x"]))
        await asyncio.wait_for(clients["a:1"].entered.wait(), 5)
        await sc.apply_membership(["b:1", "c:1"])
        got = await asyncio.wait_for(task, 5)
        await sc.aclose()
        return got

    assert run(scenario()) in (["b:1"], ["c:1"])
    assert clients["a:1"].closed
    for name in ("klogs_shard_reroutes_total", "klogs_shard_endpoint_ready"):
        assert all("a:1" not in key for key, _ in
                   registry.family(name).children()), name
