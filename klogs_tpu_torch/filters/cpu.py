"""The gate policy of the thousand-pattern path.

Counterpart of the gate half of ``klogs_tpu/filters/cpu.py``
(``INDEX_MIN_K`` .. ``note_sweep_supersedes``); the host engines of
``--backend cpu`` are not ported yet. The rule reads the JAX package's
own variables, through ``utils/env.py``:

- ``KLOGS_TPU_SWEEP`` (auto | 0 | 1): the device literal sweep. Auto
  turns it on for K >= ``index_min_k()`` on a ``cuda`` device (the JAX
  rule "on a real accelerator"), so the CPU runs without it unless it
  is forced;
- ``KLOGS_INDEX_MIN_K``: the K threshold of auto mode;
- ``KLOGS_TPU_PREFILTER=1``: the pair-CNF gate, which an auto sweep
  does not override (a forced sweep does);
- ``KLOGS_TPU_FUSED_GROUPS=1`` (``ops/tune.py``): the fused-groups
  kernel, which has no gated variant (``check_fused_gates``).
"""

import torch

from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.env import read as env_read

# Pattern-set size from which auto mode gates the grouped kernel with
# the literal sweep.
INDEX_MIN_K = 64


def index_min_k() -> int:
    """The auto-mode thousand-pattern threshold (KLOGS_INDEX_MIN_K,
    default INDEX_MIN_K; a malformed value reads as the default, as in
    the JAX package)."""
    try:
        return int(env_read("KLOGS_INDEX_MIN_K", str(INDEX_MIN_K)))
    except ValueError:
        return INDEX_MIN_K


def device_sweep_env() -> str:
    """Validated KLOGS_TPU_SWEEP (auto | 0 | 1). A malformed value
    raises: a typo'd knob silently running without the sweep would be
    an unexplained slowdown at thousand-pattern K."""
    env = env_read("KLOGS_TPU_SWEEP", "auto")
    if env not in ("auto", "0", "1"):
        raise ValueError(
            f"KLOGS_TPU_SWEEP={env!r}: expected auto, 0 or 1")
    return env


def device_sweep_wanted(n_patterns: int, device: torch.device) -> bool:
    """Forced by KLOGS_TPU_SWEEP=1, off by =0; in auto mode on for
    K >= index_min_k() on a ``cuda`` device only."""
    env = device_sweep_env()
    if env != "auto":
        return env == "1"
    return n_patterns >= index_min_k() and device.type == "cuda"


def device_gate_choice(n_patterns: int, have_prefilter: bool,
                       device: torch.device) -> str:
    """The sweep-vs-prefilter precedence (the kernel takes one gate):

    - ``"off"``: the sweep is not wanted; keep whatever prefilter the
      caller built;
    - ``"prefilter"``: the sweep is wanted but an explicit
      KLOGS_TPU_PREFILTER=1 wins over an auto sweep (notice printed);
    - ``"sweep"``: build the sweep tables; the caller drops a working
      prefilter only after they built (``note_sweep_supersedes``).
    """
    if not device_sweep_wanted(n_patterns, device):
        return "off"
    if have_prefilter and device_sweep_env() != "1":
        term.info(
            "KLOGS_TPU_PREFILTER=1 active; device sweep stays "
            "off (set KLOGS_TPU_SWEEP=1 to prefer the sweep)")
        return "prefilter"
    return "sweep"


def note_sweep_supersedes() -> None:
    """The notice when a forced sweep replaces a working prefilter."""
    term.info(
        "KLOGS_TPU_SWEEP=1 supersedes KLOGS_TPU_PREFILTER: "
        "the literal sweep subsumes the pair-CNF gate")


def check_fused_gates(n_patterns: int, device: torch.device) -> None:
    """The fused-versus-gate rule, settled once when the engine is
    built (the JAX engine meets it at every dispatch): the fused kernel
    has no gated variant. A forced gate, KLOGS_TPU_PREFILTER=1 or
    KLOGS_TPU_SWEEP=1, raises in the JAX launcher's words: running
    another kernel than the one asked for would corrupt a measurement.
    An auto sweep that would turn on stays off, with a notice; that is
    what the JAX engine ends up running once its dispatch degrades."""
    if env_read("KLOGS_TPU_PREFILTER", "0") == "1":
        raise ValueError(
            "fused=True (KLOGS_TPU_FUSED_GROUPS) has no gated variant; "
            "drop the prefilter tables or unset KLOGS_TPU_PREFILTER")
    if device_sweep_env() == "1":
        raise ValueError(
            "fused=True (KLOGS_TPU_FUSED_GROUPS) has no gated variant; "
            "drop the sweep tables or unset KLOGS_TPU_SWEEP")
    if device_sweep_wanted(n_patterns, device):
        term.info(
            "KLOGS_TPU_FUSED_GROUPS=1 active; device sweep stays off (the "
            "fused kernel has no gated variant; unset "
            "KLOGS_TPU_FUSED_GROUPS to gate)")
