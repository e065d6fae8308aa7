"""The host engines of ``--backend cpu``, and the gate policy of the
thousand-pattern path.

Counterpart of ``klogs_tpu/filters/cpu.py``. Three engines, in
ascending strength, and the ladder that picks among them:

- ``RegexFilter``: K sequential ``re.search`` calls per line, the
  reference-parity baseline;
- ``CombinedRegexFilter``: one compiled alternation
  ``(?:p1)|(?:p2)|...``, one `re` pass per line;
- ``DFAFilter``: the subset-construction DFA of
  ``filters/compiler/dfa.py`` (through its on-disk table cache),
  scanned by ``dfa_scan`` in ``native/_hostops.c``. The scan always
  runs in C: a C module that does not build raises ``NativeBuildError``
  when the engine is built; ``dfa.scan_python`` is its plain version,
  which only the tests run.

``best_host_filter`` picks the strongest engine the set admits, as in
the JAX package: the indexed engine (``filters/indexed.py``) from
``KLOGS_INDEX_MIN_K`` patterns, then one union DFA, then a combined
alternation (not for sets with group references, which a combined
alternation renumbers), then K-sequential `re`; ``KLOGS_CPU_ENGINE``
(auto | indexed | dfa | combined | re) forces one. A rung is skipped
only when the set is inadmissible there (``ValueError``, which covers
``RegexSyntaxError`` and ``DFAStateOverflow``, or ``re.error``); any
other error (a C build, a CUDA error) propagates, where the JAX ladder
catches every exception.

The gate policy reads the JAX package's own variables, through
``utils/env.py``:

- ``KLOGS_TPU_SWEEP`` (auto | 0 | 1): the device literal sweep. Auto
  turns it on for K >= ``index_min_k()`` on a ``cuda`` device (the JAX
  rule "on a real accelerator"), so the CPU runs without it unless it
  is forced;
- ``KLOGS_INDEX_MIN_K``: the K threshold of auto mode, shared with
  ``best_host_filter``;
- ``KLOGS_TPU_PREFILTER=1``: the pair-CNF gate, which an auto sweep
  does not override (a forced sweep does);
- ``KLOGS_TPU_FUSED_GROUPS=1`` (``ops/tune.py``): the fused-groups
  kernel, which has no gated variant (``check_fused_gates``).
"""

import re

import numpy as np
import torch

from klogs_tpu_torch.filters.base import LogFilter, frame_lines
from klogs_tpu_torch.filters.compiler.parser import GROUP_REF_TOKENS
from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.env import read as env_read

# The renumbering-sensitive features (backreferences, conditional group
# references): a combined alternation renumbers groups, so sets using
# them stay on the K-sequential engine. Built from the compiler's table.
_GROUP_REF_RE = re.compile("|".join(GROUP_REF_TOKENS))
# The errors that make a pattern set inadmissible to an engine (a rung of
# best_host_filter's ladder, or an indexed group's DFA): RegexSyntaxError
# and DFAStateOverflow are ValueErrors. Anything else propagates.
_INADMISSIBLE = (ValueError, re.error)


class RegexFilter(LogFilter):
    """K sequential ``re.search`` calls per line."""

    def __init__(self, patterns: list[str], ignore_case: bool = False):
        if not patterns:
            raise ValueError("RegexFilter needs at least one pattern")
        flags = re.IGNORECASE if ignore_case else 0
        self._compiled = [re.compile(p.encode(), flags) for p in patterns]

    def match_lines(self, lines: list[bytes]) -> list[bool]:
        compiled = self._compiled
        out = []
        for line in lines:
            body = line.rstrip(b"\n")
            out.append(any(p.search(body) for p in compiled))
        return out


class CombinedRegexFilter(LogFilter):
    """One alternation, one `re` scan per line. Same verdicts as
    RegexFilter for any-match semantics (group numbering differs, but
    no captures are consumed)."""

    def __init__(self, patterns: list[str], ignore_case: bool = False):
        if not patterns:
            raise ValueError("CombinedRegexFilter needs at least one pattern")
        flags = re.IGNORECASE if ignore_case else 0
        joined = b"|".join(b"(?:%s)" % p.encode() for p in patterns)
        self._compiled = re.compile(joined, flags)

    def match_lines(self, lines: list[bytes]) -> list[bool]:
        search = self._compiled.search
        return [search(line.rstrip(b"\n")) is not None for line in lines]


class DFAStateOverflow(ValueError):
    """Subset construction exceeded the state budget: the set is
    DFA-compilable, just not together. The indexed engine's group
    builder retries on halves; anything else treats it as an
    inadmissible set."""


class DFAFilter(LogFilter):
    """Determinized union automaton + the C flat-table scan.

    Raises ValueError (or RegexSyntaxError) when the pattern set is
    outside the compiler subset, or DFAStateOverflow when the subset
    construction exceeds ``max_states``. The C module is built (or
    loaded) here, so a failed build raises ``NativeBuildError`` before
    any line is scanned."""

    def __init__(self, patterns: list[str], ignore_case: bool = False,
                 max_states: "int | None" = None, cache: bool = True,
                 cache_events=None):
        from klogs_tpu_torch.filters.compiler.dfa import (
            DEFAULT_MAX_STATES,
            build_dfa,
            build_dfa_cached,
        )
        from klogs_tpu_torch.native import hostops

        if not patterns:
            raise ValueError("DFAFilter needs at least one pattern")
        if cache:
            t = build_dfa_cached(patterns, ignore_case=ignore_case,
                                 max_states=max_states or DEFAULT_MAX_STATES,
                                 on_event=cache_events)
        else:
            # Throwaway table sets (fuzz trials): no disk write.
            from klogs_tpu_torch.filters.compiler.glushkov import (
                compile_patterns,
            )

            t = build_dfa(compile_patterns(patterns,
                                           ignore_case=ignore_case),
                          max_states or DEFAULT_MAX_STATES)
        if t is None:
            raise DFAStateOverflow(
                f"DFA for {len(patterns)} pattern(s) exceeds "
                f"{max_states or DEFAULT_MAX_STATES} states")
        self._hostops = hostops()
        self._t = t
        self._table_b = t.table.tobytes()
        self._accept_b = t.accept.tobytes()
        self._bclass_b = t.byte_class.tobytes()

    @property
    def tables(self):
        """The compiled DFATables (the indexed engine's MultiDFA blob
        packs these: filters/compiler/index.py ``multidfa_blob``)."""
        return self._t

    def match_lines(self, lines: list[bytes]) -> list[bool]:
        payload, offsets, _ = frame_lines(lines)
        return self._scan(payload, offsets).tolist()

    def dispatch_framed(self, payload: bytes, offsets):
        return self._scan(payload, offsets)

    def fetch_framed(self, handle):
        return handle

    def _scan(self, payload: bytes, offsets) -> np.ndarray:
        n = len(offsets) - 1
        t = self._t
        if t.match_all:
            return np.ones(n, dtype=bool)
        mask = self._hostops.dfa_scan(
            payload, np.ascontiguousarray(offsets, dtype=np.int32), n,
            self._table_b, t.n_classes, self._accept_b, self._bclass_b,
            t.start, t.end_class, 1 if t.table.dtype == np.uint32 else 0)
        return np.frombuffer(mask, dtype=np.uint8).astype(bool)

# Pattern-set size from which auto mode takes the indexed host engine
# and gates the grouped kernel with the literal sweep.
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


def note_sweep_supersedes(mesh: bool = False) -> None:
    """The notice when a forced sweep replaces a working prefilter (on
    every shard of a mesh engine, ``mesh``)."""
    term.info(
        "KLOGS_TPU_SWEEP=1 supersedes KLOGS_TPU_PREFILTER%s: "
        "the literal sweep subsumes the pair-CNF gate",
        " on the mesh" if mesh else "")


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



def best_host_filter(patterns: list[str], ignore_case: bool = False,
                     registry=None):
    """Strongest host engine this pattern set admits (module
    docstring); returns (filter, kind). ``registry`` (an obs Registry)
    receives the indexed engine's klogs_prefilter_*/klogs_sweep_*/
    klogs_groupscan_* families when given."""
    choice = env_read("KLOGS_CPU_ENGINE", "auto")
    if choice == "re":
        return RegexFilter(patterns, ignore_case=ignore_case), "re"
    if choice == "combined":
        return (CombinedRegexFilter(patterns, ignore_case=ignore_case),
                "combined-re")
    if choice == "indexed" or (choice == "auto"
                               and len(patterns) >= index_min_k()):
        from klogs_tpu_torch.filters.indexed import IndexedFilter

        try:
            return (IndexedFilter(patterns, ignore_case=ignore_case,
                                  registry=registry),
                    "indexed")
        except _INADMISSIBLE as e:
            if choice == "indexed":
                raise
            # Loud: at this K the ladder below is far slower.
            term.warning(
                "indexed engine failed for this %d-pattern set (%s: %s); "
                "falling back to the DFA/combined-re ladder",
                len(patterns), type(e).__name__, e)
    try:
        return DFAFilter(patterns, ignore_case=ignore_case), "dfa"
    except _INADMISSIBLE:
        if choice == "dfa":
            raise
    # A combined alternation renumbers groups: backreferences and
    # conditional group references would resolve to the wrong group.
    if any(_GROUP_REF_RE.search(p) for p in patterns):
        return RegexFilter(patterns, ignore_case=ignore_case), "re"
    try:
        return (CombinedRegexFilter(patterns, ignore_case=ignore_case),
                "combined-re")
    except re.error:
        return RegexFilter(patterns, ignore_case=ignore_case), "re"
