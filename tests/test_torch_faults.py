"""The port's fault layer against the JAX package's: the ``KLOGS_FAULTS``
grammar (the same specs accepted and rejected, with the same messages),
the injector's firing semantics, the policy's retry counter and fault
point, and the same ``kube.log_stream`` and ``sink.write`` faults
through both apps: the same files and the same counters.

Tolerance: exact (files byte for byte, counters equal)."""

import asyncio
import json
import re

import pytest
import torch

from klogs_tpu import app as jax_app
from klogs_tpu import obs as jax_obs
from klogs_tpu.cli import parse_args as jax_parse_args
from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster
from klogs_tpu.obs import trace as jax_trace
from klogs_tpu.resilience import FAULTS as JAX_FAULTS
from klogs_tpu.resilience import faults as jax_faults
from klogs_tpu.resilience import policy as jax_policy
from klogs_tpu.runtime import fanout as jax_fanout
from klogs_tpu_torch import app, cli, obs
from klogs_tpu_torch.cluster.fake import FakeCluster
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.resilience import FAULTS, faults, policy
from klogs_tpu_torch.runtime import fanout


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLOCK = 1_753_800_000.0


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """No armed fault outlives a test, in either package; reconnects
    back off briefly."""
    for f in (FAULTS, JAX_FAULTS):
        f.clear()
        f.bind_registry(None)
    for mod in (fanout, jax_fanout):
        monkeypatch.setattr(mod, "_BACKOFF_BASE_S", 0.01)
        monkeypatch.setattr(mod, "_BACKOFF_MAX_S", 0.05)
    yield
    for f in (FAULTS, JAX_FAULTS):
        f.clear()
        f.bind_registry(None)
    trace.reset(None)
    jax_trace.reset(None)


SPECS = [
    "kube.log_stream:error",
    "kube.log_stream:error*3; sink.write:delay(0.01)*",
    "rpc.match@127.0.0.1:50051:error*",
    "rpc.match@unix:/tmp/x.sock:error(gone)*2",
    "source.read:error(boom), source.open:delay(0.5)",
    "  ;  ,",
    "tune.step:error*0",
    "kube.watch:error",
    "kube.log_stream:explode",
    "kube.log_stream",
    "sink.write:delay(abc)",
    "rpc.match@nohost:error",
    "rpc.match@host:99999:error",
    "rpc.match@unix::error",
    "KUBE.list_pods:error",
]


def _outcome(injector_cls, err_cls, spec: str):
    inj = injector_cls()
    try:
        inj.load_spec(spec)
    except err_cls as e:
        return ("error", str(e))
    return ("ok", {p: [(r.times, r.delay_s, r.target, r.exc is not None)
                       for r in rules] for p, rules in inj._rules.items()})


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_equals_jax(spec):
    got = _outcome(faults.FaultInjector, faults.FaultSpecError, spec)
    exp = _outcome(jax_faults.FaultInjector, jax_faults.FaultSpecError, spec)
    assert got == exp
    assert faults.KNOWN_POINTS == jax_faults.KNOWN_POINTS


def test_firing_counts_targets_and_registry_equal_jax():
    out = {}
    for side, (mod, obs_mod) in {"torch": (faults, obs),
                                 "jax": (jax_faults, jax_obs)}.items():
        inj = mod.FaultInjector()
        reg = obs_mod.Registry()
        inj.bind_registry(reg)
        inj.load_spec("kube.log_stream:error*2; rpc.match@h:1:error(x)*")
        log = []

        async def fire(point, target=None):
            try:
                await inj.fire(point, target)
                log.append("pass")
            except mod.InjectedFault as e:
                log.append(str(e))

        async def main():
            for _ in range(3):
                await fire("kube.log_stream")
            await fire("rpc.match", "h:2")
            await fire("rpc.match", "h:1")
            await fire("sink.write")

        asyncio.run(main())
        fam = reg.family("klogs_faults_injected_total")
        out[side] = (log, dict(inj.counts), inj.active,
                     [(lv, c.value) for lv, c in fam.children()])
    assert out["torch"] == out["jax"]
    assert out["torch"][0][:3] == ["injected fault at kube.log_stream"] * 2 \
        + ["pass"]


def test_retry_call_fault_point_and_counter():
    """An armed fault at ``retry_call``'s point drives its real retry
    path and counts each retry, as in the JAX package."""
    out = {}
    for side, (pol, mod, obs_mod) in {
            "torch": (policy, faults, obs),
            "jax": (jax_policy, jax_faults, jax_obs)}.items():
        inj = mod.FAULTS
        inj.load_spec("rpc.match@e:1:error*2")
        reg = obs_mod.Registry()
        calls = []

        async def fn(deadline):
            calls.append(deadline)
            return "ok"

        res = asyncio.run(pol.retry_call(
            fn, policy=pol.RetryPolicy(max_attempts=4, base_s=0.001,
                                       max_s=0.002, jitter=0.0),
            retryable=lambda e: False, site="rpc@e:1",
            fault_point="rpc.match", fault_target="e:1", registry=reg))
        out[side] = (res, len(calls), reg.family(
            "klogs_retry_attempts_total").labels(site="rpc@e:1").value)
        inj.clear()
    assert out["torch"] == out["jax"] == ("ok", 1, 2)


def test_breaker_state_gauge_equals_jax():
    out = {}
    for side, (pol, obs_mod) in {"torch": (policy, obs),
                                 "jax": (jax_policy, jax_obs)}.items():
        reg = obs_mod.Registry()
        t = [0.0]
        br = pol.CircuitBreaker("svc", failure_threshold=2,
                                reset_timeout_s=1.0, clock=lambda: t[0],
                                registry=reg)
        g = reg.family("klogs_breaker_state").labels(breaker="svc")
        seen = [g.value]
        br.record_failure()
        br.record_failure()
        seen.append(g.value)
        t[0] = 2.0
        br.allow()
        seen.append(g.value)
        br.record_success()
        seen.append(g.value)
        out[side] = seen
    assert out["torch"] == out["jax"] == [0, 1, 2, 0]


# -- through both apps ------------------------------------------------------


def _expected(fc, pattern: str) -> dict:
    rx = re.compile(pattern.encode())
    return {f"{pod}__{c}.log": b"".join(ln for _, ln in cont.lines
                                        if rx.search(ln))
            for pod, p in fc.namespaces["default"].items()
            for c, cont in p.containers.items()}


def _fault_run(tmp_path, side: str, spec: str, follow: bool,
               monkeypatch) -> tuple:
    monkeypatch.setenv("KLOGS_FAULTS", spec)
    out = tmp_path / side
    argv = ["-n", "default", "-a", "-p", str(out / "logs"), "--match",
            "ERROR", "--stats-json", str(out / "s.json")]
    if follow:
        argv.append("-f")
    kw = dict(n_pods=4, lines_per_container=60, clock=lambda: CLOCK,
              follow_interval_s=3600.0)
    if side == "jax":
        fc = JaxFakeCluster.synthetic(**kw)
        opts = jax_parse_args(argv + ["--backend", "cpu"])
    else:
        fc = FakeCluster.synthetic(**kw)
        opts = cli.parse_args(argv)
    exp = _expected(fc, "ERROR")

    def files() -> dict:
        d = out / "logs"
        return {p.name: p.read_bytes() for p in sorted(d.iterdir())} \
            if d.exists() else {}

    async def main():
        stop = asyncio.Event()
        run = (jax_app.run_async(opts, backend=fc, stop=stop) if side == "jax"
               else app.run_async(opts, backend=fc, stop=stop, device="cpu"))
        task = asyncio.create_task(run)
        if follow:
            for _ in range(500):
                await asyncio.sleep(0.02)
                if files() == exp:
                    break
            stop.set()
        return await asyncio.wait_for(task, 60)

    assert asyncio.run(main()) == 0
    with open(out / "s.json") as f:
        metrics = json.load(f)["metrics"]
    counters = {name: sorted((tuple(sorted(s.get("labels", {}).items())),
                              s["value"]) for s in metrics[name]["samples"])
                for name in ("klogs_faults_injected_total",
                             "klogs_retry_attempts_total",
                             "klogs_fanout_stream_errors_total",
                             "klogs_fanout_reconnects_total")}
    return files(), counters, exp


@pytest.mark.parametrize("spec, follow", [
    ("kube.log_stream:error*2", True),
    ("kube.log_stream:error*", False),
    ("sink.write:error*", False),
], ids=["log_stream_follow", "log_stream_every_open", "sink_write"])
def test_faults_through_both_apps(tmp_path, monkeypatch, spec, follow):
    got_files, got, exp_files = _fault_run(tmp_path, "torch", spec, follow,
                                           monkeypatch)
    jax_files, exp, _ = _fault_run(tmp_path, "jax", spec, follow,
                                   monkeypatch)
    assert got_files == jax_files
    assert got == exp
    point = spec.split(":")[0]
    fired = dict(got["klogs_faults_injected_total"])[(("point", point),)]
    if follow:
        # The faulted opens reconnect; every file ends exact.
        assert got_files == exp_files
        assert fired == 2
        assert dict(got["klogs_retry_attempts_total"])[
            (("site", "fanout"),)] == 2
    else:
        # Every stream (or every sink with lines to write) failed once.
        assert fired == 4
        assert dict(got["klogs_fanout_stream_errors_total"])[()] == 4
        assert all(v == b"" for v in got_files.values())
