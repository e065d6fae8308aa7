"""The port's operating point: ``KLOGS_MAX_IN_FLIGHT``,
``KLOGS_COALESCE_LINES`` and ``KLOGS_FETCH_WORKERS`` on its
AsyncFilterService, ``apply_tuning``, and the ``KLOGS_TUNE=auto``
``AdaptiveController`` (``ops/tune.py``), each held against the JAX
package's; then the JAX test_tune.py contracts of the controller on the
port."""

import asyncio
import importlib.util
import json
import random
import threading

import numpy as np
import pytest

from klogs_tpu.filters import async_service as jax_async_service
from klogs_tpu.filters.base import FilterStats as JaxFilterStats
from klogs_tpu.ops import tune as jax_tune
from klogs_tpu_torch.filters import async_service
from klogs_tpu_torch.filters.base import FilterStats
from klogs_tpu_torch.obs import profiler
from klogs_tpu_torch.ops import tune

KNOBS = (("KLOGS_MAX_IN_FLIGHT", "max_in_flight", 16),
         ("KLOGS_COALESCE_LINES", "coalesce_lines", 8192),
         ("KLOGS_FETCH_WORKERS", "fetch_workers", 8))


def fresh_module(mod, name: str):
    """``mod``'s file executed anew as module ``name`` (its knobs read at
    import), without touching ``sys.modules[mod.__name__]``."""
    spec = importlib.util.spec_from_file_location(name, mod.__file__)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    return fresh


def knob_values(mod) -> dict:
    svc = mod.AsyncFilterService(object())
    try:
        return {"max_in_flight": svc.max_in_flight,
                "coalesce_lines": svc.coalesce_lines,
                "fetch_workers": svc._pool._max_workers}
    finally:
        svc._pool.shutdown()


@pytest.mark.parametrize("knob,attr,default", KNOBS)
@pytest.mark.parametrize("raw", [None, "64", "3", "0", "-2", "lots"])
def test_service_knobs_equal_jax(knob, attr, default, raw, monkeypatch,
                                 capsys):
    """Each knob sets the service's value as in JAX, and 0, a negative or
    garbage warns on stderr with the same line and runs the default."""
    if raw is None:
        monkeypatch.delenv(knob, raising=False)
    else:
        monkeypatch.setenv(knob, raw)
    capsys.readouterr()
    mine = knob_values(fresh_module(async_service, "port_async_probe"))
    mine_err = capsys.readouterr().err
    ref = knob_values(fresh_module(jax_async_service, "jax_async_probe"))
    ref_err = capsys.readouterr().err
    assert mine == ref
    assert mine_err == ref_err
    bad = raw in ("0", "-2", "lots")
    assert mine[attr] == (int(raw) if raw and not bad else default)
    assert bool(mine_err) == bad


# ---- apply_tuning, live, against JAX ---------------------------------

class HeldFilter:
    """A filter whose fetches wait until ``release`` is set, so batches
    stay in flight."""

    def __init__(self) -> None:
        self.release = threading.Event()

    def dispatch_framed(self, payload, offsets):
        return len(offsets) - 1

    def fetch_framed(self, n):
        self.release.wait(10)
        return np.zeros(n, dtype=bool)

    def close(self) -> None:
        pass


def tuning_story(mod) -> list:
    """Six one-line callers at depth 4 (coalesce_lines 1: a group each),
    then the depth raised to 8 and cut to 2 with the batches in flight,
    then released: (used slots, free permits) at each step."""
    filt = HeldFilter()
    svc = mod.AsyncFilterService(filt, max_in_flight=4, coalesce_lines=1)
    payload, offsets = b"x", np.array([0, 1], dtype=np.int32)

    async def go():
        snaps = []

        async def snap(label):
            for _ in range(20):
                await asyncio.sleep(0)
            await asyncio.sleep(0.05)
            snaps.append((label, svc._in_flight_used(), svc._sem._value,
                          svc.max_in_flight))

        calls = [asyncio.create_task(svc.match_framed(payload, offsets))
                 for _ in range(6)]
        await snap("start")
        svc.apply_tuning(max_in_flight=8)
        await snap("up")
        svc.apply_tuning(max_in_flight=2, coalesce_lines=3)
        await snap("down")
        filt.release.set()
        await asyncio.gather(*calls)
        await snap("retired")
        await svc.aclose()
        snaps.append(("closed", len(svc._tasks), svc.coalesce_lines,
                      svc.batches_dispatched))
        return snaps

    return asyncio.run(go())


def test_apply_tuning_equals_jax():
    mine, ref = tuning_story(async_service), tuning_story(jax_async_service)
    assert mine == ref
    assert mine[:4] == [("start", 4.0, 0, 4), ("up", 6.0, 2, 8),
                        ("down", 2.0, 0, 2), ("retired", 0.0, 2, 2)]


def queued_story(mod, tune_mod, stats) -> tuple:
    """Six one-line callers at depth 2 with coalesce_lines 1: each
    caller's frame fills a group at once, two groups hold the slots and
    four wait for one. (the queue-depth probe, the slots used, two
    controller ticks on those samples)."""
    filt = HeldFilter()
    svc = mod.AsyncFilterService(filt, max_in_flight=2, coalesce_lines=1,
                                 stats=stats)
    payload, offsets = b"x", np.array([0, 1], dtype=np.int32)

    async def go():
        calls = [asyncio.create_task(svc.match_framed(payload, offsets))
                 for _ in range(6)]
        for _ in range(20):
            await asyncio.sleep(0)
        await asyncio.sleep(0.05)
        depth = svc._probes["coalescer.queue_depth"]()
        used = svc._probes["device.in_flight_used"]()
        doc = {"enabled": True, "samples": {
            "device.in_flight_used": used, "coalescer.queue_depth": depth,
            "coalescer.pending_lines": svc._probes[
                "coalescer.pending_lines"]()}}
        ctrl = tune_mod.AdaptiveController(
            svc, profile_fn=lambda: doc, interval_s=0.01, step=0.5,
            surface={"max_in_flight": (2, 64)})
        ticks = [await ctrl.step_once(doc) for _ in range(2)]
        filt.release.set()
        await asyncio.gather(*calls)
        await svc.aclose()
        return depth, used, ticks

    return asyncio.run(go())


def test_queue_depth_probe_counts_callers_waiting_for_a_slot():
    """Callers whose group waits for an in-flight slot are queued callers:
    the port's ``coalescer.queue_depth`` probe counts them, so with every
    slot taken the controller steps the depth up on its second tick. The
    JAX package's probe counts only callers still coalescing and reads 0
    here, and its controller holds: under many callers whose frames fill
    a group at once, the pressure it was built to see is invisible
    (ROADMAP §C, reference fault 8)."""
    mine = queued_story(async_service, tune, FilterStats())
    ref = queued_story(jax_async_service, jax_tune, JaxFilterStats())
    assert mine == (4.0, 2.0, [None, ("max_in_flight", "up")])
    assert ref == (0.0, 2.0, [None, None])


def test_shared_budget_service_is_not_tunable(monkeypatch):
    """The registry's services share one semaphore: no controller, and
    apply_tuning refuses."""
    monkeypatch.setenv("KLOGS_TUNE", "auto")
    shared = async_service.AsyncFilterService(
        HeldFilter(), in_flight=asyncio.Semaphore(4))
    own = async_service.AsyncFilterService(HeldFilter())
    try:
        assert not shared.tunable and own.tunable
        assert tune.maybe_controller(shared) is None
        assert tune.maybe_controller(own) is not None
        with pytest.raises(RuntimeError, match="shared"):
            shared.apply_tuning(max_in_flight=8)
    finally:
        shared._pool.shutdown()
        own._pool.shutdown()


# ---- the controller against JAX's, tick for tick -----------------------

class FakeTunedService:
    """Duck-types the AsyncFilterService tuning surface."""

    def __init__(self, coalesce=524288, flight=16):
        self._c, self._f = coalesce, flight
        self.applied = []

    @property
    def coalesce_lines(self):
        return self._c

    @property
    def max_in_flight(self):
        return self._f

    def apply_tuning(self, coalesce_lines=None, max_in_flight=None):
        self.applied.append((coalesce_lines, max_in_flight))
        if coalesce_lines is not None:
            self._c = coalesce_lines
        if max_in_flight is not None:
            self._f = max_in_flight


def seeded_docs(rng: random.Random, svc: FakeTunedService):
    """A profile doc in one of the regimes the policy tells apart, held
    for a seeded number of ticks."""
    while True:
        regime = rng.choice(["press_flight", "press_group", "idle", "mixed",
                             "disabled"])
        for _ in range(rng.randint(1, 7)):
            f, c = svc.max_in_flight, svc.coalesce_lines
            if regime == "disabled":
                yield {"enabled": False}
                continue
            used = {"press_flight": float(f), "press_group": 1.0,
                    "idle": 0.0}.get(regime, rng.uniform(0, f))
            depth = {"press_flight": float(rng.randint(1, 5)),
                     "idle": 0.0}.get(regime, float(rng.randint(0, 3)))
            pending = {"press_group": float(c * rng.uniform(1, 2)),
                       "idle": 0.0}.get(regime, float(c * rng.random()))
            yield {"enabled": True, "samples": {
                "device.in_flight_used": used,
                "coalescer.queue_depth": depth,
                "coalescer.pending_lines": pending}}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_decisions_equal_jax(seed):
    """The same bounds and one seeded sequence of profile docs: the
    port's decisions and values equal JAX's after every tick."""
    rng = random.Random(seed)
    surface = tune.operating_surface()
    start = dict(coalesce=rng.choice([2048, 8192, 65536]),
                 flight=rng.choice([4, 16, 48]))
    mine, ref = FakeTunedService(**start), FakeTunedService(**start)
    c = tune.AdaptiveController(mine, interval_s=1.0, step=0.5,
                                surface=surface)
    j = jax_tune.AdaptiveController(ref, interval_s=1.0, step=0.5,
                                    surface=surface)
    assert c.bounds == j.bounds

    async def go():
        got, exp = [], []
        docs = seeded_docs(rng, mine)
        for _ in range(400):
            doc = next(docs)
            got.append((await c.step_once(doc), dict(c.values)))
            exp.append((await j.step_once(doc), dict(j.values)))
        return got, exp

    got, exp = asyncio.run(go())
    assert got == exp
    assert mine.applied == ref.applied
    assert sum(1 for d, _ in got if d) >= 5


def test_controller_metrics_equal_jax():
    """``klogs_tune_steps_total`` and ``klogs_tune_value`` after the same
    ticks, in each package's registry."""
    from klogs_tpu import obs as jax_obs
    from klogs_tpu_torch import obs

    out = []
    for mod, o in ((tune, obs), (jax_tune, jax_obs)):
        reg = o.Registry()
        o.register_all(reg)
        svc = FakeTunedService()
        ctrl = mod.AdaptiveController(svc, registry=reg, surface=SURFACE,
                                      interval_s=1.0, step=0.5)
        for doc in [_press_doc(svc)] * 2 + [_idle_doc()] * 7:
            _step(ctrl, doc)
        out.append({k: [(lv, child.value)
                        for lv, child in reg.family(k).children()]
                    for k in ("klogs_tune_steps_total", "klogs_tune_value")})
    assert out[0] == out[1]
    assert out[0]["klogs_tune_value"]


# ---- the JAX test_tune.py contracts, on the port --------------------

SURFACE = {"coalesce_lines": (262144, 1048576), "max_in_flight": (8, 64)}


def _ctrl(svc=None, **kw):
    svc = FakeTunedService() if svc is None else svc
    kw.setdefault("interval_s", 0.01)
    kw.setdefault("step", 0.5)
    kw.setdefault("surface", SURFACE)
    return tune.AdaptiveController(svc, **kw), svc


def _press_doc(svc):
    return {"enabled": True, "samples": {
        "device.in_flight_used": float(svc.max_in_flight),
        "coalescer.queue_depth": 3.0,
        "coalescer.pending_lines": 0.0}}


def _idle_doc():
    return {"enabled": True, "samples": {
        "device.in_flight_used": 0.0,
        "coalescer.queue_depth": 0.0,
        "coalescer.pending_lines": 0.0}}


def _step(ctrl, doc):
    return asyncio.run(ctrl.step_once(doc))


def test_operating_surface_reads_the_cards_sweep():
    """The envelope is the card's committed sweep (and never the TPU's
    OPERATING_POINT.json); the profiler's operating point is its best
    lines/s, each record named with the card and its power limit."""
    with open(tune.OPERATING_POINT) as f:
        doc = json.load(f)
    runs = [r for e in doc for r in e["runs"]]
    assert all("H100" in e["device"] and e["power_limit"] for e in doc)
    assert tune.operating_surface() == {
        "coalesce_lines": (min(r["batch"] for r in runs),
                           max(r["batch"] for r in runs)),
        "max_in_flight": (min(r["n_flight"] for r in runs),
                          max(r["n_flight"] for r in runs))}
    assert tune.operating_surface()["max_in_flight"] == (4, 64)
    assert tune.operating_surface()["coalesce_lines"] == (2048, 131072)
    assert profiler._operating_point_lps() == max(r["lps"] for r in runs)
    assert tune.operating_surface() != jax_tune.operating_surface()


def test_operating_surface_without_the_file(monkeypatch, tmp_path):
    monkeypatch.setattr(tune, "OPERATING_POINT", str(tmp_path / "none.json"))
    assert tune.operating_surface() == {}
    assert profiler._operating_point_lps() is None
    (tmp_path / "bad.json").write_text("{not json")
    monkeypatch.setattr(tune, "OPERATING_POINT", str(tmp_path / "bad.json"))
    assert tune.operating_surface() == {}


def test_tune_mode_default_off_and_validation(monkeypatch):
    monkeypatch.delenv("KLOGS_TUNE", raising=False)
    assert tune.tune_mode() == "off"
    monkeypatch.setenv("KLOGS_TUNE", " AUTO ")
    assert tune.tune_mode() == "auto"
    monkeypatch.setenv("KLOGS_TUNE", "sorta")
    with pytest.raises(ValueError, match="KLOGS_TUNE"):
        tune.tune_mode()


def test_maybe_controller_off_is_none_auto_builds(monkeypatch):
    svc = FakeTunedService()
    monkeypatch.delenv("KLOGS_TUNE", raising=False)
    assert tune.maybe_controller(svc) is None
    assert svc.applied == []
    monkeypatch.setenv("KLOGS_TUNE", "auto")
    assert tune.maybe_controller(svc) is not None
    # No tuning surface (the remote tier) -> no controller.
    assert tune.maybe_controller(object()) is None


def test_controller_bounds_hug_surface_and_initial():
    ctrl, _ = _ctrl()
    assert ctrl.bounds == {"coalesce_lines": (262144, 1048576),
                           "max_in_flight": (8, 64)}
    ctrl2, _ = _ctrl(FakeTunedService(coalesce=131072, flight=128))
    assert ctrl2.bounds["coalesce_lines"][0] == 131072
    assert ctrl2.bounds["max_in_flight"][1] == 128
    ctrl3, svc3 = _ctrl(surface={})
    assert ctrl3.bounds["max_in_flight"] == (16, 16)
    for _ in range(10):
        _step(ctrl3, _press_doc(svc3))
    assert ctrl3.steps_applied == 0


def test_controller_steps_up_after_sustained_pressure():
    ctrl, svc = _ctrl()
    assert _step(ctrl, _press_doc(svc)) is None
    assert _step(ctrl, _press_doc(svc)) == ("max_in_flight", "up")
    assert svc.max_in_flight == 24
    assert _step(ctrl, _press_doc(svc)) is None
    assert _step(ctrl, _press_doc(svc)) is None
    assert ctrl.steps_applied == 1


def test_controller_steps_down_after_sustained_idle():
    ctrl, svc = _ctrl()
    for _ in range(3):
        assert _step(ctrl, _idle_doc()) is None
    assert _step(ctrl, _idle_doc()) == ("max_in_flight", "down")
    assert svc.max_in_flight == 10


def test_controller_group_pressure_steps_coalescer():
    ctrl, svc = _ctrl()
    doc = {"enabled": True, "samples": {
        "device.in_flight_used": 1.0,
        "coalescer.queue_depth": 0.0,
        "coalescer.pending_lines": float(svc.coalesce_lines)}}
    _step(ctrl, doc)
    assert _step(ctrl, doc) == ("coalesce_lines", "up")
    assert svc.coalesce_lines == 786432


def test_controller_pinned_at_ceiling_holds():
    ctrl, svc = _ctrl(FakeTunedService(flight=64))
    for _ in range(6):
        assert _step(ctrl, _press_doc(svc)) is None
    assert svc.max_in_flight == 64 and svc.applied == []


def test_controller_disabled_doc_and_oscillation_hold():
    ctrl, svc = _ctrl()
    assert _step(ctrl, {"enabled": False}) is None
    for i in range(100):
        doc = _press_doc(svc) if i % 2 else _idle_doc()
        _step(ctrl, doc)
    assert ctrl.steps_applied == 0 and svc.applied == []


@pytest.mark.parametrize("knob", ["KLOGS_TUNE_INTERVAL_S",
                                  "KLOGS_TUNE_STEP"])
@pytest.mark.parametrize("bad", ["nan", "inf", "0", "-1"])
def test_controller_env_knobs_fail_loudly(monkeypatch, knob, bad):
    monkeypatch.setenv(knob, bad)
    with pytest.raises(ValueError, match=knob):
        tune.AdaptiveController(FakeTunedService(), surface=SURFACE)


def test_controller_run_loop_survives_injected_faults():
    """An armed ``tune.step`` fault skips each tick and never ends the
    loop."""
    from klogs_tpu_torch.resilience import FAULTS

    holder = []
    ctrl, svc = _ctrl(profile_fn=lambda: _press_doc(holder[0]),
                      interval_s=0.01)
    holder.append(svc)

    async def scenario():
        FAULTS.load_spec("tune.step:error*")
        stop = asyncio.Event()
        task = asyncio.create_task(ctrl.run(stop))
        await asyncio.sleep(0.1)
        stop.set()
        await asyncio.wait_for(task, 5)

    try:
        asyncio.run(scenario())
    finally:
        FAULTS.clear()
    assert ctrl.steps_applied == 0


def test_controller_run_loop_steps_on_live_pressure():
    """Without faults the same loop steps: the ticks reach step_once."""
    holder = []
    ctrl, svc = _ctrl(profile_fn=lambda: _press_doc(holder[0]),
                      interval_s=0.01)
    holder.append(svc)

    async def scenario():
        stop = asyncio.Event()
        task = asyncio.create_task(ctrl.run(stop))
        await asyncio.sleep(0.2)
        stop.set()
        await asyncio.wait_for(task, 5)

    asyncio.run(scenario())
    assert ctrl.steps_applied >= 1 and svc.max_in_flight > 16
