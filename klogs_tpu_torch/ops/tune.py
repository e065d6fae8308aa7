"""Kernel selection and autotuning: pick the grouped kernel by measurement.

Counterpart of the kernel half of ``klogs_tpu/ops/tune.py``. The
full-line scan has two kernels on the card that compute one function:
K1 (``nfa_kernels.match_cls_grouped``, the plain chain, variant ``{}``)
and K4 (``match_cls_grouped_fused``, variant ``{"fused": True}``).
Which is faster depends on the pattern set and the batch, so it is
measured, not guessed: ``tune_grouped`` times both pipelined on the
live card and caches the winner per (card, automaton shape, batch
geometry) in ``$XDG_CACHE_HOME/klogs_tpu_torch/tune.json``.

The hot path never reads that cache, so a stale one cannot change what
a run does: the engine takes ``chain_selection``, which reads
``KLOGS_TPU_FUSED_GROUPS`` alone. The TPU's layout knobs have no CUDA
counterpart. ``KLOGS_TPU_TILE`` raises, and so do
``KLOGS_TPU_INTERLEAVE`` and ``KLOGS_TPU_MASK_BLOCK`` set to anything
but ``1`` (which restates the plain chain): quietly running another
kernel than the one an operator asked to measure would corrupt the
pick by measurement. No variant is defaulted on any device until a
measurement on the card sets one.

Each ``tune_grouped`` sweep counts into ``klogs_engine_tune_runs_total``
and sets ``klogs_engine_tune_best_lines_per_second`` (the caller's
registry, else the process-wide one).

The second half is the pipeline's operating point, online:
``KLOGS_TUNE=auto`` builds an ``AdaptiveController`` (counterpart of the
JAX one, with its policy and constants) that moves the coalescer's
``coalesce_lines`` and the in-flight depth ``max_in_flight`` of the
collector's ``AsyncFilterService`` from the live ``/profile`` signals.
Its envelope is ``operating_point.json`` beside this module: the sweep
of those two settings that ``ops/bench_operating_point.py`` measured
through the service on an H100, with the card's name and power limit in
each record. The JAX package's ``OPERATING_POINT.json`` holds a TPU's
sweep and is never read. ``KLOGS_TUNE=off`` (the default) builds
nothing: the fixed flags.
"""

import asyncio
import functools
import json
import os
from typing import Any, Callable

import torch

from klogs_tpu_torch.ops import nfa_kernels
from klogs_tpu_torch.utils.env import read as env_read

CANDIDATE_VARIANTS = (
    {},  # plain: K1
    {"fused": True},  # K4
)

# Pallas layout choices with no counterpart in the CUDA kernels; "1"
# restates the plain chain for the two that take a count.
_TPU_ONLY = ("KLOGS_TPU_TILE", "KLOGS_TPU_INTERLEAVE", "KLOGS_TPU_MASK_BLOCK")
# KLOGS_TPU_KERNEL values that pick the JAX package's paths without the
# Pallas kernels (jnp; the kernels interpreted on the host).
_JAX_ONLY_KERNELS = ("jnp", "interpret")


def _cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "klogs_tpu_torch", "tune.json")


def device_kind(device: torch.device) -> str:
    """The card's name for a cuda device, else the device type."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _key(prog: Any, batch_shape: Any, kind: str) -> str:
    G, C, S = prog.char_mask.shape
    return f"{kind}|G{G}|S{S}|C{C}|B{batch_shape[0]}x{batch_shape[1]}"


def load_cached(prog: Any, batch_shape: Any, kind: str) -> "dict | None":
    try:
        with open(_cache_path()) as f:
            return json.load(f).get(_key(prog, batch_shape, kind))
    except (OSError, ValueError):
        return None


def _store(prog: Any, batch_shape: Any, kind: str, cfg: dict) -> None:
    path = _cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        with open(path) as f:
            all_cfg = json.load(f)
    except (OSError, ValueError):
        all_cfg = {}
    all_cfg[_key(prog, batch_shape, kind)] = cfg
    with open(path, "w") as f:
        json.dump(all_cfg, f, indent=1)


def measure_grouped(prog: Any, live: int, acc: int, cls: torch.Tensor,
                    repeats: int = 3, n_flight: int = 6,
                    **variant: Any) -> float:
    """Lines/s of one variant's wrapper on ``cls`` (a cuda tensor): the
    best of ``repeats`` windows of ``n_flight`` launches in flight and one
    wait, timed with CUDA events (a wait per launch would time the host
    round trip, not the kernel)."""
    kernel = (nfa_kernels.match_cls_grouped_fused if variant.get("fused")
              else nfa_kernels.match_cls_grouped)
    kernel(prog, live, acc, cls)  # build, load, bit tables
    torch.cuda.synchronize(cls.device)
    best = 0.0
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_flight):
            kernel(prog, live, acc, cls)
        end.record()
        end.synchronize()
        best = max(best, n_flight * cls.shape[0] * 1e3
                   / start.elapsed_time(end))
    return best


def tune_grouped(prog: Any, live: int, acc: int, cls: torch.Tensor,
                 repeats: int = 3, n_flight: int = 6,
                 runner: "Callable[..., float] | None" = None,
                 quiet: bool = False, registry: Any = None) -> dict:
    """Time every variant of ``CANDIDATE_VARIANTS`` on ``cls`` ([B, T]
    class ids) and return the winner, ``{**variant, "lines_per_s",
    "results"}`` (``results``: every variant that ran, as
    ``{**variant, "lines_per_s"}``), caching it. ``runner(**variant) ->
    lines/s`` is injectable for tests;
    the default is ``measure_grouped`` on the card, and a ``cls`` off the
    card then raises. A variant whose runner raises is skipped. The
    sweep's telemetry goes to ``registry`` (an obs Registry), else to
    the process-wide one."""
    if runner is None:
        if cls.device.type != "cuda":
            raise RuntimeError(
                f"tune_grouped times the kernels on a cuda device; cls is "
                f"on {cls.device}")
        runner = functools.partial(measure_grouped, prog, live, acc, cls,
                                   repeats, n_flight)
    results = []
    for variant in CANDIDATE_VARIANTS:
        desc = " ".join(f"{k}={v}" for k, v in variant.items()) or "plain"
        try:
            lps = runner(**variant)
        except Exception as e:  # a build or launch failure of one variant
            if not quiet:
                print(f"tune: {desc} failed: {str(e)[:80]}")
            continue
        if lps > 0:
            results.append({**variant, "lines_per_s": round(lps, 1)})
            if not quiet:
                print(f"tune: {desc} -> {lps:,.0f} lines/s")
    if not results:
        raise RuntimeError("kernel tuning failed for every candidate config")
    best = dict(max(results, key=lambda r: r["lines_per_s"]), results=results)
    if registry is None:
        from klogs_tpu_torch.obs import REGISTRY as registry
    registry.family("klogs_engine_tune_runs_total").inc()
    registry.family("klogs_engine_tune_best_lines_per_second").set(
        best["lines_per_s"])
    _store(prog, cls.shape, device_kind(cls.device), best)
    return best


def env_overrides() -> dict:
    """``{"fused": True}`` under KLOGS_TPU_FUSED_GROUPS=1, else ``{}``.
    The TPU-only knobs raise ``ValueError`` (``=1`` restates the plain
    chain for KLOGS_TPU_INTERLEAVE and KLOGS_TPU_MASK_BLOCK), and so does
    KLOGS_TPU_KERNEL=jnp or =interpret, which ask for the JAX package's
    paths without its kernels (``auto`` and ``pallas``, the kernels,
    pass)."""
    kernel = env_read("KLOGS_TPU_KERNEL")
    if kernel in _JAX_ONLY_KERNELS:
        raise ValueError(
            f"KLOGS_TPU_KERNEL={kernel!r} is a TPU-only choice (the JAX "
            "package's path without its Pallas kernels); the port runs "
            "its CUDA kernels, so unset it or set it to auto or pallas")
    for name in _TPU_ONLY:
        value = env_read(name)
        if value and (name == "KLOGS_TPU_TILE" or value != "1"):
            raise ValueError(
                f"{name}={value!r} is a TPU-only choice (a layout of the "
                "Pallas kernels); the CUDA kernels have no counterpart, so "
                "unset it" + ("" if name == "KLOGS_TPU_TILE"
                              else " or set it to 1"))
    return {"fused": True} if env_read("KLOGS_TPU_FUSED_GROUPS") == "1" else {}


def chain_selection() -> dict:
    """The variant the engine runs: the operator's ``env_overrides()``.
    No variant is defaulted on any device until a measurement on the
    card sets one; whether the chosen variant may meet a gate is settled
    by ``filters/cpu.py`` ``check_fused_gates`` when the engine is
    built."""
    return env_overrides()


# The controller below moves the pipeline's operating point online:
# bounded multiplicative steps, a streak of ticks before each, a cooldown
# after it, and bounds from the card's measured surface.

DEFAULT_TUNE_INTERVAL_S = 5.0
DEFAULT_TUNE_STEP = 0.5  # up = x(1 + step), down = /(1 + step)
_TUNE_UP_AFTER = 2    # pressure ticks in a row before a step up
_TUNE_DOWN_AFTER = 4  # idle ticks in a row before a step down
_TUNE_COOLDOWN = 2    # ticks held after any step

# The operating-point sweep of the card (ops/bench_operating_point.py).
OPERATING_POINT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "operating_point.json")


def tune_mode() -> str:
    """``KLOGS_TUNE``: ``off`` (the default: the fixed flags, no
    controller built) or ``auto``; anything else raises ``ValueError``,
    as in the JAX package."""
    raw = env_read("KLOGS_TUNE")
    mode = (raw or "off").strip().lower()
    if mode not in ("off", "auto"):
        raise ValueError(f"KLOGS_TUNE must be 'off' or 'auto', got {raw!r}")
    return mode


def operating_point_runs() -> "list[dict]":
    """Every run of every record in ``operating_point.json``; empty when
    the file is missing or malformed."""
    try:
        with open(OPERATING_POINT, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    try:
        return [run for entry in doc for run in entry.get("runs", [])
                if isinstance(run, dict)]
    except (TypeError, AttributeError):
        return []


def operating_surface() -> "dict[str, tuple[int, int]]":
    """The measured (min, max) of each controller parameter over the
    card's sweep: the envelope the controller may roam. Empty without
    the file: the bounds then collapse to the initial values, and the
    controller holds."""
    batches: "list[int]" = []
    flights: "list[int]" = []
    for run in operating_point_runs():
        b, nf = run.get("batch"), run.get("n_flight")
        if isinstance(b, int) and not isinstance(b, bool):
            batches.append(b)
        if isinstance(nf, int) and not isinstance(nf, bool):
            flights.append(nf)
    out: "dict[str, tuple[int, int]]" = {}
    if batches:
        out["coalesce_lines"] = (min(batches), max(batches))
    if flights:
        out["max_in_flight"] = (min(flights), max(flights))
    return out


class AdaptiveController:
    """Closes the loop from ``/profile`` to the service's two settings.

    Each tick (``step_once`` on the live profile doc):

    - *pressure*: every in-flight slot taken with callers queued, or a
      full group pending. After ``_TUNE_UP_AFTER`` such ticks in a row
      the binding parameter steps up one bounded multiplicative step.
    - *idle*: in-flight use under a quarter of the depth with an empty
      coalescer. After ``_TUNE_DOWN_AFTER`` such ticks in a row it steps
      down, depth first, toward the flags.
    - anything else resets both streaks; every step is followed by
      ``_TUNE_COOLDOWN`` held ticks. A signal that flips each tick moves
      nothing.

    Bounds are ``[min(initial, surface_min), max(initial, surface_max)]``
    from ``operating_surface``: the controller roams the measured
    envelope and can always return to the operator's flags.

    ``service`` duck-types the ``coalesce_lines``/``max_in_flight``
    properties and ``apply_tuning`` (``filters/async_service.py``). The
    state is touched only from the one task that runs ``run``.
    """

    PARAMS = ("coalesce_lines", "max_in_flight")

    def __init__(self, service: Any, *,
                 registry: Any = None,
                 profile_fn: "Callable[[], dict] | None" = None,
                 interval_s: "float | None" = None,
                 step: "float | None" = None,
                 surface: "dict[str, tuple[int, int]] | None" = None
                 ) -> None:
        from klogs_tpu_torch.utils.env import positive_float

        self._service = service
        if profile_fn is None:
            from klogs_tpu_torch.obs.profiler import PROFILER

            profile_fn = PROFILER.profile_doc
        self._profile_fn = profile_fn
        self._interval_s = (interval_s if interval_s is not None
                            else positive_float("KLOGS_TUNE_INTERVAL_S",
                                                DEFAULT_TUNE_INTERVAL_S))
        self._step = (step if step is not None
                      else positive_float("KLOGS_TUNE_STEP",
                                          DEFAULT_TUNE_STEP))
        self.values: "dict[str, int]" = {
            "coalesce_lines": int(service.coalesce_lines),
            "max_in_flight": int(service.max_in_flight),
        }
        surf = operating_surface() if surface is None else surface
        self.bounds: "dict[str, tuple[int, int]]" = {}
        for param, initial in self.values.items():
            lo, hi = surf.get(param, (initial, initial))
            self.bounds[param] = (min(initial, lo), max(initial, hi))
        self._press = 0
        self._idle = 0
        self._cooldown = 0
        self.steps_applied = 0
        self._m_steps: Any = None
        self._m_value: Any = None
        if registry is not None:
            self._m_steps = registry.family("klogs_tune_steps_total")
            self._m_value = registry.family("klogs_tune_value")
            for param, value in self.values.items():
                self._m_value.labels(param=param).set(value)

    async def _apply(self, param: str, new: int, direction: str) -> None:
        self.values[param] = new
        self._service.apply_tuning(**{param: new})
        self.steps_applied += 1
        self._press = 0
        self._idle = 0
        self._cooldown = _TUNE_COOLDOWN
        if self._m_steps is not None:
            self._m_steps.labels(param=param, direction=direction).inc()
        if self._m_value is not None:
            self._m_value.labels(param=param).set(new)
        from klogs_tpu_torch.ui import term

        term.info("tune: %s %s -> %d (operating-point controller)",
                  param, direction, new)

    async def _step_up(self, param: str) -> bool:
        cur = self.values[param]
        hi = self.bounds[param][1]
        if cur >= hi:
            return False
        new = min(hi, max(cur + 1, int(cur * (1.0 + self._step))))
        await self._apply(param, new, "up")
        return True

    async def _step_down(self, param: str) -> bool:
        cur = self.values[param]
        lo = self.bounds[param][0]
        if cur <= lo:
            return False
        new = max(lo, min(cur - 1, int(cur / (1.0 + self._step))))
        await self._apply(param, new, "down")
        return True

    async def step_once(self, doc: dict) -> "tuple[str, str] | None":
        """One decision from one profile doc: the ``(param, direction)``
        applied, or None (held). Async so that every change of state
        stays on the loop."""
        if not doc.get("enabled"):
            return None
        samples = doc.get("samples") or {}

        def sample(name: str) -> float:
            v = samples.get(name)
            return float(v) if isinstance(v, (int, float)) else 0.0

        depth = sample("coalescer.queue_depth")
        pending = sample("coalescer.pending_lines")
        used = sample("device.in_flight_used")
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        flight = self.values["max_in_flight"]
        group = self.values["coalesce_lines"]
        # Pressure: every slot busy with callers queued behind them, or
        # a full group's lines pending before the kick.
        press_flight = used >= flight - 0.5 and depth > 0
        press_group = pending >= group
        idle = (used <= max(1.0, 0.25 * flight)
                and depth <= 0 and pending < 0.25 * group)
        if press_flight or press_group:
            self._press += 1
            self._idle = 0
        elif idle:
            self._idle += 1
            self._press = 0
        else:
            self._press = 0
            self._idle = 0
        if self._press >= _TUNE_UP_AFTER:
            if press_flight and await self._step_up("max_in_flight"):
                return ("max_in_flight", "up")
            if press_group and await self._step_up("coalesce_lines"):
                return ("coalesce_lines", "up")
            self._press = 0  # at the ceiling
            return None
        if self._idle >= _TUNE_DOWN_AFTER:
            # Depth first (memory and queueing), then the group size.
            if await self._step_down("max_in_flight"):
                return ("max_in_flight", "down")
            if await self._step_down("coalesce_lines"):
                return ("coalesce_lines", "down")
            self._idle = 0  # at the floor
            return None
        return None

    async def run(self, stop: "asyncio.Event") -> None:
        """Tick every ``KLOGS_TUNE_INTERVAL_S`` until ``stop``. The
        ``tune.step`` fault point wraps each decision: an armed fault,
        or any other error of a tick, skips that tick and never ends the
        loop."""
        from klogs_tpu_torch.resilience import FAULTS
        from klogs_tpu_torch.ui import term

        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=self._interval_s)
            except asyncio.TimeoutError:
                pass
            if stop.is_set():
                return
            try:
                if FAULTS.active:
                    await FAULTS.fire("tune.step")
                await self.step_once(self._profile_fn())
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                term.warning("tune: skipped a control tick (%s)", e)


def maybe_controller(service: Any, registry: Any = None
                     ) -> "AdaptiveController | None":
    """None under ``KLOGS_TUNE=off`` (nothing is built), None for a
    service that cannot be tuned (the remote tier, or a service over the
    registry's shared in-flight budget), else a controller ready to run.
    A bad ``KLOGS_TUNE*`` value raises ``ValueError``."""
    if tune_mode() == "off":
        return None
    if (getattr(service, "apply_tuning", None) is None
            or not getattr(service, "tunable", True)):
        return None
    return AdaptiveController(service, registry=registry)
