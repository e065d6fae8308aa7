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
registry, else the process-wide one). The JAX module's
``AdaptiveController`` (``KLOGS_TUNE=auto``) is not ported: its envelope
is an operating-point sweep of the TPU, and the card has none yet, so
``tune_mode`` refuses ``auto`` rather than run the fixed flags quietly.
"""

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
    chain for KLOGS_TPU_INTERLEAVE and KLOGS_TPU_MASK_BLOCK)."""
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


def tune_mode() -> str:
    """``KLOGS_TUNE``: ``off`` (the default: the fixed flags). ``auto``,
    the JAX package's adaptive controller, raises ``ValueError``: it is
    not ported yet. Anything else raises as in the JAX package."""
    raw = env_read("KLOGS_TUNE")
    mode = (raw or "off").strip().lower()
    if mode == "auto":
        raise ValueError(
            "KLOGS_TUNE=auto: the adaptive operating-point controller is "
            "not ported to the CUDA engine yet (it needs an operating-point "
            "sweep of the card); unset KLOGS_TUNE or set it to off")
    if mode != "off":
        raise ValueError(f"KLOGS_TUNE must be 'off' or 'auto', got {raw!r}")
    return mode
