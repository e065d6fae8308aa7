"""IndexedFilter: the thousand-pattern host engine of ``--backend cpu``.

Counterpart of ``klogs_tpu/filters/indexed.py``. Two phases per batch,
per "Regular Expression Indexing for Log Analysis" (PAPERS.md): one
shared factor-index sweep (filters/compiler/index.py) narrows each line
to its candidate pattern GROUPS, then only those groups' compiled
engines scan the line. The pattern set is partitioned by
filters/compiler/groups.py into bounded, factor-clustered groups, each
compiled to the strongest engine it admits (DFA through the on-disk
table cache; combined-`re`; else K-sequential `re`; a group whose DFA
overflows its state budget is bisected first), so compile cost and
subset construction stay bounded at thousands of patterns while scan
cost tracks candidates, not K.

Verdicts equal RegexFilter's (any match over the whole set): the index
is a necessary condition, so a skipped (line, group) pair never hides
a match. ``narrow=False`` runs the same group engines over every line.

The stages, all in C on the host unless the device sweep is on:

- **sweep**: ``sweep_candidates`` (native/_hostops.c) over slabs of
  ``NATIVE_SLAB_LINES``; with ``KLOGS_SWEEP_PIPELINE`` (auto: depth 2
  on a multi-core host) a worker sweeps slab i+1 while the main thread
  confirms slab i, with every shared mutation kept on the main thread
  in slab order, so the verdicts and stats equal the serial schedule's;
- **group scan**: ``group_scan`` confirms every DFA-backed group's
  candidate cells in one GIL-free call a slab; the combined-re/re
  groups run after it, per group, on their candidate rows;
- **adaptive**: the bypass (``KLOGS_INDEX_BYPASS_RATIO``/``_LINES``)
  switches a stream the index does not narrow to scan-all, and the
  one-shot re-guard (``KLOGS_INDEX_DENSE_RATIO``/``_LINES``) bans guard
  factors seen in most lines and re-anchors probe windows on observed
  codes, then rebuilds the index (and the device tables).

**The device sweep.** ``sweep="device"`` narrows each slab on the card:
the framed payload and its int64 starts and lengths cross once (one
pinned buffer), ``pack_rows`` (ops/pack.py, a CUDA kernel) cuts the
rows there, and ``ops/sweep.py`` ``sweep_group_candidates`` evaluates
the same index's ``SweepProgram``; its mask equals the host sweep's bit
for bit. ``device`` picks the card (None means ``cuda`` and raises
without one; the tests pass ``"cpu"``, which runs the plain versions).
``sweep="auto"`` (the default) turns it on only in a process that has
already initialised CUDA on an available card
(``torch.cuda.is_initialized()``), unless ``KLOGS_TPU_SWEEP=0``; so a
plain ``--backend cpu`` run never touches the card. (The JAX rule,
"jax already imported and its backend is not cpu", means nothing here:
every process of the port imports torch.) ``sweep="host"`` never uses
the card. A slab with a line over ``SWEEP_MAX_WIDTH`` bytes, or whose
padded rows pass ``SWEEP_MAX_BATCH_BYTES``, sweeps on the host: a
route by width, as in JAX.

**No hidden degrade.** Where the JAX engine catches a failure and goes
on more slowly, the port raises: a device-sweep failure (JAX falls back
to the host sweep for good), a C module that does not build
(``NativeBuildError``; JAX falls back to the numpy sweep, the per-group
loop and ``scan_python``), and ``KLOGS_NATIVE_SIMD=off`` or
``KLOGS_NATIVE_GROUPSCAN=off``, which select those plain versions in
JAX. The plain versions (``FactorIndex.group_candidates(impl="numpy")``,
``_scan_candidates(..., impl="python")``) are reached by tests only.

Spans: each slab's sweep is a ``device.sweep`` span (``path``: device or
host) and its confirm a ``device.groupscan`` span (``impl``, ``rows``,
``cells``), as in JAX.
"""

import re
import time
from typing import Any

import numpy as np
import torch

from klogs_tpu_torch.filters.base import LogFilter, frame_lines
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.filters.compiler.groups import (
    MAX_GROUP_PATTERNS,
    MAX_GROUP_POSITIONS,
    GroupPlan,
    PatternInfo,
    analyze,
    plan_groups,
)
from klogs_tpu_torch.filters.compiler.index import FactorIndex

# Per-group DFA state budget: small enough that ~128 groups of tables
# stay cache-friendly and subset construction per group is sub-second;
# a group that overflows is bisected (_build_groups), and a singleton
# that still overflows runs combined-`re`.
GROUP_MAX_STATES = 8192
# Lines per sweep slab: bounds the sweep's transient numpy arrays
# (~16 bytes per payload byte) regardless of caller batch size.
SLAB_LINES = 65536
# The C sweep's packed path holds only the sweep's u32 bitset
# (4*ceil(G/32) bytes per line) plus verdict bytes per slab, so it
# affords a 4x larger slab: fewer per-slab Python round trips. The
# device sweep keeps the small bound above.
NATIVE_SLAB_LINES = 262144
# Device-sweep row-width cap: a slab holding a line longer than this
# sweeps on the host instead (padding every row to a jumbo line's
# width would swamp the device pass; long lines are rare in log
# corpora and the host sweep is O(payload)).
SWEEP_MAX_WIDTH = 4096
# ... and a padded-batch byte cap: ONE moderately long line in a full
# slab would otherwise pad rows x width to hundreds of MB (65536 rows
# x 4096 B = 256 MB for ~10 MB of payload). Past the cap the slab
# narrows on the host: the same route, bounded memory.
SWEEP_MAX_BATCH_BYTES = 64 << 20
# Adaptive bypass (KLOGS_INDEX_BYPASS_RATIO / _LINES): once this many
# lines have been swept, a cumulative narrowing ratio still above the
# threshold means the index is not paying for itself on this stream —
# switch to scan-all for subsequent batches and say so once.
BYPASS_RATIO = 0.5
BYPASS_MIN_LINES = 65536
# Adaptive re-guard (KLOGS_INDEX_DENSE_RATIO / _LINES): after the
# probation window, guard factors observed in more than DENSE_RATIO of
# swept lines are banned and the index re-guarded — see the
# constructor comment. RATIO >= 1 disables (no factor can exceed it).
DENSE_RATIO = 0.5
DENSE_MIN_LINES = 65536


class _Group:
    """One compiled pattern group: members + the strongest engine the
    group admits."""

    def __init__(self, members: "list[int]", patterns: "list[str]",
                 ignore_case: bool, cache: bool,
                 on_cache_event: Any) -> None:
        from klogs_tpu_torch.filters.cpu import (
            _GROUP_REF_RE,
            _INADMISSIBLE,
            CombinedRegexFilter,
            DFAFilter,
            DFAStateOverflow,
            RegexFilter,
        )

        self.members = members
        self.patterns = patterns
        # True when the DFA failed on the STATE BUDGET alone: the set
        # is compilable, just not together — the group builder bisects
        # those instead of degrading every member to combined-re.
        self.split_hint = False
        try:
            self.filt: LogFilter = DFAFilter(
                patterns, ignore_case=ignore_case,
                max_states=GROUP_MAX_STATES, cache=cache,
                cache_events=on_cache_event)
            self.kind = "dfa"
            return
        except DFAStateOverflow:
            self.split_hint = True
        except _INADMISSIBLE:
            # Outside the compiler subset; a C build error propagates.
            pass
        if any(_GROUP_REF_RE.search(p) for p in patterns):
            # Renumbering-sensitive groups stay K-sequential (same rule
            # as best_host_filter; see filters/cpu.py).
            self.filt = RegexFilter(patterns, ignore_case=ignore_case)
            self.kind = "re"
            return
        try:
            self.filt = CombinedRegexFilter(patterns,
                                            ignore_case=ignore_case)
            self.kind = "combined-re"
        except re.error:
            self.filt = RegexFilter(patterns, ignore_case=ignore_case)
            self.kind = "re"


def _build_groups(members: "list[int]", patterns: "list[str]",
                  ignore_case: bool, cache: bool,
                  on_cache_event: Any) -> "list[_Group]":
    """Compile one planned group, bisecting on DFA state overflow.

    Half the union usually fits the budget (subset construction grows
    superlinearly in the union automaton), and every half that does
    rides the batched C group_scan instead of sending the WHOLE group
    to the per-line combined-re path. Singletons that still overflow
    stay combined-re (or re)."""
    grp = _Group(members, [patterns[i] for i in members], ignore_case,
                 cache, on_cache_event)
    if grp.kind == "dfa" or not grp.split_hint or len(members) < 2:
        return [grp]
    mid = (len(members) + 1) // 2
    return (_build_groups(members[:mid], patterns, ignore_case, cache,
                          on_cache_event)
            + _build_groups(members[mid:], patterns, ignore_case,
                            cache, on_cache_event))


class IndexedFilter(LogFilter):
    """Factor-index narrowing + per-group scan (module docstring)."""

    def __init__(self, patterns: "list[str]", ignore_case: bool = False,
                 *, narrow: bool = True, cache: bool = True,
                 max_group_patterns: int = MAX_GROUP_PATTERNS,
                 max_group_positions: int = MAX_GROUP_POSITIONS,
                 registry: Any = None, sweep: str = "auto",
                 device: Any = None) -> None:
        if not patterns:
            raise ValueError("IndexedFilter needs at least one pattern")
        if sweep not in ("auto", "host", "device"):
            raise ValueError(
                f"sweep={sweep!r}: expected auto, host or device")
        from klogs_tpu_torch.obs.metrics import Registry

        self.registry = registry if registry is not None else Registry()
        r = self.registry
        self._m_clauses = r.family("klogs_prefilter_pattern_clauses")
        self._m_factors = r.family("klogs_prefilter_pattern_factors")
        self._m_ratio = r.family("klogs_prefilter_narrowing_ratio")
        self._m_groups = r.family("klogs_prefilter_groups")
        cache_events = r.family("klogs_prefilter_table_cache_events_total")
        self._m_cache = {kind: cache_events.labels(event=kind)
                         for kind in ("hit", "miss", "evict")}
        self._m_sweep_batches = r.family("klogs_sweep_batches_total")
        self._m_sweep_lines = r.family("klogs_sweep_lines_total")
        self._m_sweep_cand = r.family("klogs_sweep_candidate_lines_total")
        self._m_sweep_s = r.family("klogs_sweep_seconds")
        # Declared as in JAX, never incremented: the port raises where
        # the JAX engine counts a fallback (module docstring).
        r.family("klogs_sweep_fallback_total")
        self._m_bypass = r.family("klogs_sweep_bypass_total")
        self._m_sweep_impl = r.family("klogs_sweep_impl_batches_total")
        gs_batches = r.family("klogs_groupscan_batches_total")
        gs_rows = r.family("klogs_groupscan_rows_total")
        gs_cells = r.family("klogs_groupscan_cells_total")
        gs_s = r.family("klogs_groupscan_seconds")
        self._m_gs = {impl: (gs_batches.labels(impl=impl),
                             gs_rows.labels(impl=impl),
                             gs_cells.labels(impl=impl),
                             gs_s.labels(impl=impl))
                      for impl in ("native", "python")}
        r.family("klogs_groupscan_fallback_total")
        self._m_reguard = r.family("klogs_prefilter_reguard_total")

        self.narrow = narrow
        self.infos: "list[PatternInfo]" = analyze(
            patterns, ignore_case=ignore_case)
        self.plan: GroupPlan = plan_groups(
            self.infos, max_group_patterns=max_group_patterns,
            max_group_positions=max_group_positions)
        for info in self.infos:
            self._m_clauses.observe(info.clauses)
            self._m_factors.observe(info.factors)
        # Compile groups, bisecting any whose union DFA overflows the
        # state budget (_build_groups); when a split happened, the plan
        # is re-derived so the index's group columns stay 1:1 with the
        # compiled groups.
        always = set(int(g) for g in self.plan.always_groups)
        self.groups = []
        split_members: "list[list[int]]" = []
        split_always: "list[int]" = []
        for g, members in enumerate(self.plan.groups):
            for grp in _build_groups(members, patterns, ignore_case,
                                     cache, self._on_cache_event):
                if g in always:
                    split_always.append(len(split_members))
                split_members.append(grp.members)
                self.groups.append(grp)
        if len(split_members) != len(self.plan.groups):
            group_of = np.zeros(len(self.infos), dtype=np.int32)
            for gi, members in enumerate(split_members):
                for p in members:
                    group_of[p] = gi
            self.plan = GroupPlan(groups=split_members,
                                  group_of=group_of,
                                  always_groups=tuple(split_always))
        self.index = FactorIndex(self.infos, self.plan)
        self._m_groups.set(len(self.groups))
        # Group partition for the confirm stage: DFA-backed groups ride
        # the batched MultiDFA native scan (one group_scan call per
        # slab); the combined-re/re remainder keeps the per-group
        # Python path.
        self._dfa_cols = [g for g, grp in enumerate(self.groups)
                          if grp.kind == "dfa"]
        self._dfa_cols_arr = np.asarray(self._dfa_cols, dtype=np.int32)
        self._rest_cols = [g for g, grp in enumerate(self.groups)
                           if grp.kind != "dfa"]
        # MultiDFA program blob cache: rebuilt (incrementally, via the
        # per-member chunk cache) only when a member group's tables
        # object changes — e.g. the DFA LRU refreshed it.
        self._mdfa_key: Any = None
        self._mdfa_blob: "bytes | None" = None
        self._mdfa_chunks: "dict[int, tuple[bytes, bytes, bytes]]" = {}
        # Per-stage time attribution (sweep / group_scan / merge):
        # cumulative seconds per pipeline stage, and which confirm
        # implementation the last slab ran.
        self.stage_s = {"sweep": 0.0, "group_scan": 0.0, "merge": 0.0}
        self.group_scan_impl = "python"
        # Cumulative narrowing tallies (bench/introspection).
        self.swept_lines = 0
        self.swept_cells = 0
        self.candidate_cells = 0
        self.candidate_lines = 0
        # Adaptive bypass state: once the stream's cumulative narrowing
        # ratio proves the index is not narrowing, stop paying the
        # sweep. bypassed is only ever flipped on, and only after
        # _bypass_min_lines have been swept.
        self.bypassed = False
        self._bypass_ratio = _env_float(
            "KLOGS_INDEX_BYPASS_RATIO", BYPASS_RATIO)
        self._bypass_min_lines = int(_env_float(
            "KLOGS_INDEX_BYPASS_LINES", BYPASS_MIN_LINES))
        # Adaptive re-guard (one-shot, probation-gated like the
        # bypass): a guard factor observed in ~every line narrows
        # nothing while taxing every sweep position AND making its
        # groups dense-candidate — after KLOGS_INDEX_DENSE_LINES swept
        # lines, factors whose line-hit density exceeds
        # KLOGS_INDEX_DENSE_RATIO are BANNED and the index rebuilt:
        # ban-aware guard extraction (factors.guard_factors) re-guards
        # each affected pattern on its next-best clause ("FATAL|CRIT"
        # instead of an omnipresent "code="), or degrades it to
        # always-candidate. Groups, plans, and compiled engines are
        # untouched; verdicts cannot change (the guard stays a
        # necessary condition under any ban).
        self._ignore_case = ignore_case
        self._reguarded = False
        self.banned_factors: "tuple[bytes, ...]" = ()
        self._dense_ratio = _env_float(
            "KLOGS_INDEX_DENSE_RATIO", DENSE_RATIO)
        self._dense_min_lines = int(_env_float(
            "KLOGS_INDEX_DENSE_LINES", DENSE_MIN_LINES))
        # Narrowing stage: the device sweep when asked for (or in auto
        # mode, in a process with CUDA initialised), else the host sweep
        # (module docstring).
        self._sweep_path = "host"
        self._sweep_tables: Any = None
        # Slab pipeline depth (KLOGS_SWEEP_PIPELINE): in-flight slabs
        # per frame, 1 = the serial schedule. Parsed once per filter.
        self._pipe_depth = _sweep_pipeline_depth()
        if sweep != "host":
            self._init_device_sweep(sweep, device)

    def _init_device_sweep(self, sweep: str, device: Any) -> None:
        from klogs_tpu_torch.ops.nfa import resolve_device
        from klogs_tpu_torch.ops.sweep import device_sweep_tables

        if sweep == "auto":
            from klogs_tpu_torch.filters.cpu import device_sweep_env

            # KLOGS_TPU_SWEEP=0 kills every auto sweep, this one too; an
            # explicit sweep="device" is code, not config, and stays.
            if device_sweep_env() == "0":
                return
            if not (torch.cuda.is_initialized()
                    and torch.cuda.is_available()):
                return
        self._sweep_tables = device_sweep_tables(
            self.index.sweep_program(), resolve_device(device))
        self._sweep_path = "device"

    def _on_cache_event(self, kind: str) -> None:
        c = self._m_cache.get(kind)
        if c is not None:
            c.inc()

    @property
    def narrowing_ratio(self) -> float:
        """Cumulative fraction of (line, group) scans the index let
        through (1.0 = no narrowing; lower is better)."""
        return (self.candidate_cells / self.swept_cells
                if self.swept_cells else 1.0)

    @property
    def engine_kinds(self) -> "dict[str, int]":
        out: "dict[str, int]" = {}
        for g in self.groups:
            out[g.kind] = out.get(g.kind, 0) + 1
        return out

    # -- matching -----------------------------------------------------

    def match_lines(self, lines: "list[bytes]") -> "list[bool]":
        payload, offsets, _ = frame_lines(lines)
        return self._match_frame(payload, np.asarray(offsets)).tolist()

    def dispatch_framed(self, payload: bytes, offsets: Any) -> Any:
        return self._match_frame(
            payload, np.ascontiguousarray(offsets, dtype=np.int32))

    def fetch_framed(self, handle: Any) -> np.ndarray:
        return np.asarray(handle, dtype=bool)

    def _match_frame(self, payload: bytes,
                     offsets: np.ndarray) -> np.ndarray:
        n = len(offsets) - 1
        out = np.zeros(n, dtype=bool)
        # Zero-copy slab views: a bytes slice would copy the whole
        # slab (~8 MB, ~1 ms/dispatch at 100k lines); every consumer
        # downstream (native "y*" parsers, np.frombuffer, re) takes
        # any buffer object.
        view = memoryview(payload)
        slab = SLAB_LINES
        native = (self.narrow and not self.bypassed
                  and self._sweep_path != "device"
                  and self.index.native_ready())
        if native:
            slab = NATIVE_SLAB_LINES
        if native and self._pipe_depth >= 2 and n > slab:
            self._match_frame_pipelined(view, offsets, out, slab)
            return out
        for lo in range(0, n, slab):
            hi = min(n, lo + slab)
            base = int(offsets[lo])
            sub_off = (offsets[lo:hi + 1] - base).astype(np.int32)
            sub_pay = view[base:int(offsets[hi])]
            out[lo:hi] = self._match_slab(sub_pay, sub_off)
        return out

    def _match_frame_pipelined(self, view: memoryview,
                               offsets: np.ndarray, out: np.ndarray,
                               slab: int) -> None:
        """Bounded slab pipeline (KLOGS_SWEEP_PIPELINE): a small worker
        pool sweeps slabs i+1..i+depth-1 while the main thread confirms
        slab i. Safe because the prefetched stage is stateless
        (FactorIndex.sweep_packed_stateless: immutable program blob,
        call-local stats buffer, kernel drops the GIL for the whole
        scan) and EVERY shared mutation — stats folds, adaptive
        bypass/re-guard probes, verdict writes — stays on the main
        thread in slab order, so verdicts and cumulative stats are
        byte-identical to the serial schedule (the serial path below,
        the one the tests hold this one to).

        An adaptive flip mid-frame (bypass, or a re-guard swapping
        ``self.index``) invalidates in-flight prefetches — they swept
        the OLD index's program — so the rest of the frame finishes on
        the serial path, which re-reads the adaptive state per slab."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        n = len(offsets) - 1
        index = self.index
        # Build the shared read-only blobs on the MAIN thread before a
        # worker can race their lazy, unlocked caches.
        index.native_sweep_blob()
        if len(self._dfa_cols):
            self._multidfa()
        bounds = [(lo, min(n, lo + slab)) for lo in range(0, n, slab)]

        def subframe(lo: int, hi: int):
            base = int(offsets[lo])
            sub_off = (offsets[lo:hi + 1] - base).astype(np.int32)
            return view[base:int(offsets[hi])], sub_off

        def guard_state():
            return (self.bypassed, self._reguarded, id(self.index),
                    self._sweep_path)

        state = guard_state()
        pending: "deque" = deque()
        nxt = 0
        with ThreadPoolExecutor(
                max_workers=self._pipe_depth - 1) as pool:
            for i, (lo, hi) in enumerate(bounds):
                # Keep up to depth slabs in flight: this one (about to
                # confirm) plus depth-1 prefetched sweeps.
                while nxt < len(bounds) and nxt - i < self._pipe_depth:
                    sp, so = subframe(*bounds[nxt])
                    pending.append(pool.submit(
                        index.sweep_packed_stateless, sp, so))
                    nxt += 1
                sp, so = subframe(lo, hi)
                out[lo:hi] = self._match_slab(
                    sp, so, prefetched=pending.popleft().result())
                if guard_state() != state:
                    for f in pending:
                        f.cancel()
                    pending.clear()
                    for lo2, hi2 in bounds[i + 1:]:
                        sp, so = subframe(lo2, hi2)
                        out[lo2:hi2] = self._match_slab(sp, so)
                    return

    def _match_slab(self, payload: bytes, offsets: np.ndarray,
                    prefetched: "tuple | None" = None) -> np.ndarray:
        B = len(offsets) - 1
        if self.narrow and not self.bypassed:
            t0 = time.perf_counter()
            path = "host"
            gm = None
            packed = None
            with trace.TRACER.span("device.sweep", lines=B) as sp:
                if self._sweep_path == "device":
                    # None: the slab's widths route it to the host.
                    gm = self._device_candidates(payload, offsets)
                    if gm is not None:
                        path = "device"
                if gm is None:
                    # The C sweep's packed bit words feed the packed
                    # group_scan zero-copy: no bool matrix on this
                    # path. A pipelined caller hands the sweep result
                    # in pre-computed; folding it here keeps the stats
                    # in slab order.
                    if prefetched is not None:
                        packed = self.index.adopt_sweep(prefetched, B)
                    else:
                        packed = self.index.group_candidates_packed(
                            payload, offsets)
                sp.set_attr("path", path)
            G = len(self.groups)
            if path == "host":
                # group_candidates already tallied this gm into
                # last_stats — reuse it instead of re-reducing a
                # multi-MB bool matrix (a measured ~4ms/slab at
                # K=1024, pure duplication).
                cand_lines = self.index.last_stats.candidate_lines
                cand_cells = self.index.last_stats.candidate_cells
            else:
                cand_lines = int(gm.any(axis=1).sum())
                cand_cells = int(gm.sum())
            self.swept_lines += B
            self.swept_cells += B * G
            self.candidate_cells += cand_cells
            self.candidate_lines += cand_lines
            ratio = cand_cells / (B * G) if B and G else 1.0
            self._m_ratio.observe(ratio)
            # Which implementation narrowed: the device or the C sweep.
            impl = ("device" if path == "device"
                    else self.index.last_impl)
            self._m_sweep_impl.labels(impl=impl).inc()
            self._m_sweep_batches.labels(path=path).inc()
            self._m_sweep_lines.labels(path=path).inc(B)
            self._m_sweep_cand.labels(path=path).inc(cand_lines)
            dt = time.perf_counter() - t0
            self.stage_s["sweep"] += dt
            self._m_sweep_s.labels(path=path).observe(dt)
            self._maybe_bypass()
            if not self._reguarded \
                    and self.swept_lines >= self._dense_min_lines:
                self._maybe_reguard(payload, offsets)
            colsums = (self.index.last_stats.col_cells
                       if path == "host" else None)
            return self._scan_candidates(payload, offsets, gm,
                                         colsums=colsums,
                                         cand_lines=cand_lines,
                                         packed=packed)
        gm = np.ones((B, len(self.groups)), dtype=bool)
        self.swept_lines += B
        self.swept_cells += B * len(self.groups)
        self.candidate_cells += B * len(self.groups)
        self.candidate_lines += B
        return self._scan_candidates(
            payload, offsets, gm,
            colsums=np.full(len(self.groups), B, dtype=np.int64))

    def _scan_candidates(self, payload: bytes, offsets: np.ndarray,
                         gm: "np.ndarray | None",
                         colsums: "np.ndarray | None" = None,
                         cand_lines: "int | None" = None,
                         packed: "np.ndarray | None" = None,
                         plain: bool = False) -> np.ndarray:
        """The confirm stage: run each line's candidate groups until
        one accepts. DFA-backed groups go through ONE C group_scan call
        per slab (zero sub-frame copies, GIL released). ``plain=True``
        runs its plain version instead, the per-group loop below (the
        same DFA table walk for every (row, group), so the same mask);
        only the tests ask for it. The combined-re/re remainder always
        takes the per-group path, after the DFA groups so it inherits
        their accepts as early-outs.

        ``packed`` (with ``gm=None``) is the sweep's raw u32 bitset,
        which the C group_scan reads directly."""
        B = len(offsets) - 1
        out = np.zeros(B, dtype=bool)
        arr = np.frombuffer(payload, dtype=np.uint8)
        lens = np.diff(offsets)
        t0 = time.perf_counter()
        impl = "python"
        rows_in = 0
        with trace.TRACER.span("device.groupscan", lines=B,
                               groups=len(self.groups)) as sp:
            scanned: "int | None" = None
            if self._dfa_cols and B and not plain:
                if gm is not None:
                    gm = np.ascontiguousarray(gm)
                # Per-member candidate counts drive the scan order
                # (most selective first) and the rows-in figure; the
                # sweep's own column reduction is reused when it ran
                # (the engine always passes it alongside packed bits;
                # the unpack below serves direct callers).
                if colsums is None:
                    if gm is None:
                        gm = np.unpackbits(packed.view(np.uint8),
                                           axis=1, bitorder="little",
                                           count=len(self.groups)
                                           ).view(bool)
                    colsums = gm.sum(axis=0, dtype=np.int64)
                dsum = colsums[self._dfa_cols_arr]
                # Lines entering confirm: the sweep's C-side count
                # when it ran (re-reducing a multi-MB bool matrix here
                # would cost a pass a slab); the small overcount from
                # rest-only candidate rows is irrelevant to the gauge.
                rows_in = (B if len(dsum) and int(dsum.max()) == B
                           else cand_lines if cand_lines is not None
                           else int(gm[:, self._dfa_cols]
                                    .any(axis=1).sum()))
                scanned = self._groupscan_native(
                    payload, offsets,
                    gm if packed is None else packed, dsum, out,
                    packed=packed is not None)
            if scanned is None:
                if gm is None:
                    gm = np.unpackbits(packed.view(np.uint8), axis=1,
                                       bitorder="little",
                                       count=len(self.groups)
                                       ).view(bool)
                scanned = 0
                for g in self._dfa_cols:
                    scanned += self._scan_group(g, gm[:, g], out,
                                                payload, offsets, arr,
                                                lens)
            else:
                impl = "native"
            dt = time.perf_counter() - t0
            self.stage_s["group_scan"] += dt
            self.group_scan_impl = impl
            sp.set_attr("impl", impl)
            sp.set_attr("rows", rows_in)
            sp.set_attr("cells", int(scanned))
            m_batches, m_rows, m_cells, m_s = self._m_gs[impl]
            m_batches.inc()
            m_rows.inc(rows_in)
            m_cells.inc(int(scanned))
            m_s.observe(dt)
        t1 = time.perf_counter()
        for g in self._rest_cols:
            # Packed fast path: extract just this group's column (one
            # shift+mask over B words) instead of unpacking the whole
            # bitset for a handful of rest groups.
            col = (gm[:, g] if gm is not None
                   else ((packed[:, g >> 5] >> np.uint32(g & 31))
                         & np.uint32(1)).astype(bool))
            self._scan_group(g, col, out, payload, offsets, arr, lens)
        self.stage_s["merge"] += time.perf_counter() - t1
        return out

    def _scan_group(self, g: int, col: np.ndarray, out: np.ndarray,
                    payload: bytes, offsets: np.ndarray,
                    arr: np.ndarray, lens: np.ndarray) -> int:
        """One group's engine over its candidate rows (``col``, bool
        [B]) not yet accepted (the per-group path). Returns the number
        of rows scanned."""
        grp = self.groups[g]
        B = len(out)
        if not col.any():
            return 0
        rows = np.nonzero(col & ~out)[0]  # already-kept rows skip
        if not len(rows):
            return 0
        if col.all() and 2 * len(rows) >= B:
            # Whole slab is candidate and most rows still undecided
            # (always-candidate groups, the scan-all comparator): the
            # engine's framed fast path — gathering a near-full
            # sub-frame copy costs more than re-scanning the few
            # already-kept rows. Once MOST rows are accepted, the
            # gathered branch below takes over so a cheap earlier
            # group's accepts are not re-scanned wholesale.
            verd = np.asarray(grp.filt.fetch_framed(
                grp.filt.dispatch_framed(payload, offsets)))
            out |= verd[:B]
            return B  # the whole frame was scanned (cells metric)
        # Candidate rows ride the framed path too: a vectorized
        # ragged gather builds the sub-frame (no per-line PyBytes —
        # the whole narrow path stays at C speed).
        sub_pay, sub_off = _gather_frame(arr, offsets, lens, rows)
        verd = np.asarray(grp.filt.fetch_framed(
            grp.filt.dispatch_framed(sub_pay, sub_off)))
        out[rows[verd[:len(rows)]]] = True
        return len(rows)

    # -- batched native group scan ------------------------------------

    def _multidfa(self) -> bytes:
        """The cached MultiDFA program blob over the DFA-backed
        groups' tables (compiler/index.py multidfa_blob). Rebuilt —
        reusing unchanged members' serialized chunks — only when a
        member's tables object changed (DFA LRU refresh)."""
        from klogs_tpu_torch.filters.compiler.index import multidfa_blob

        tables = [self.groups[g].filt.tables for g in self._dfa_cols]
        key = tuple(id(t) for t in tables)
        if self._mdfa_key != key or self._mdfa_blob is None:
            live = set(key)
            for stale in [k for k in self._mdfa_chunks
                          if k not in live]:
                del self._mdfa_chunks[stale]
            self._mdfa_blob = multidfa_blob(tables,
                                            chunks=self._mdfa_chunks)
            self._mdfa_key = key
        return self._mdfa_blob

    def _groupscan_native(self, payload: bytes, offsets: np.ndarray,
                          cand: np.ndarray, dsum: np.ndarray,
                          out: np.ndarray, packed: bool = False) -> int:
        """One C group_scan call over every (row, DFA-group) candidate
        cell, writing verdicts into ``out`` in place (monotonic 0->1
        writes only). ``cand`` is passed WHOLE, zero copies, with a
        stride and a member-column map: the bool [B, G] matrix, or with
        ``packed=True`` the sweep's raw u32[B, ceil(G/32)] bitset (the C
        indexes bit cols[m] instead of byte column cols[m], so
        ``_dfa_cols_arr`` serves both shapes). ``dsum`` is the
        per-DFA-member candidate count. Returns the scanned-cell count;
        a failure raises."""
        from klogs_tpu_torch.filters.compiler.index import (
            native_groupscan_mode,
        )
        from klogs_tpu_torch.native import hostops

        native_groupscan_mode()
        # Most selective group first: rows accepted by a rarely-
        # candidate group skip the broader (and the always-candidate)
        # groups entirely. Members with zero candidates are omitted
        # (the C pays a column skip-walk per listed member).
        order = np.argsort(dsum, kind="stable").astype(np.int32)
        order = np.ascontiguousarray(order[dsum[order] > 0])
        off = np.ascontiguousarray(offsets, dtype=np.int32)
        return int(hostops().group_scan(
            self._multidfa(), payload, off, len(off) - 1, cand,
            cand.shape[1], self._dfa_cols_arr, order, out,
            1 if packed else 0))

    def _maybe_bypass(self) -> None:
        """Adaptive bypass: after the probation window, a cumulative
        narrowing ratio above the threshold means the sweep is not
        ruling out enough scans to pay for itself — switch this stream
        to scan-all for subsequent batches and say so ONCE."""
        if (self.bypassed
                or self.swept_lines < self._bypass_min_lines
                or self.narrowing_ratio <= self._bypass_ratio):
            return
        self.bypassed = True
        self._m_bypass.inc()
        from klogs_tpu_torch.ui import term

        term.info(
            "index narrowing ratio %.2f stayed above %.2f after %d "
            "lines; switching to scan-all for subsequent batches",
            self.narrowing_ratio, self._bypass_ratio, self.swept_lines)

    def _maybe_reguard(self, payload: bytes,
                       offsets: np.ndarray) -> None:
        """One-shot adaptive re-tune of the narrowing tables
        (constructor comment), two measurements off one probation
        slab:

        - **re-guard**: per-FACTOR line-hit density via the numpy
          sweep's own hit extraction — factors present in ~every line
          are banned and their patterns re-guarded on next-best
          clauses;
        - **re-anchor**: observed 4-byte-code densities — probe
          windows the static prior placed on corpus-dense text
          (``errcode=00881`` anchored on ``code``) move to the
          window the corpus actually keeps rare.

        Only the index tables rebuild; groups and compiled engines
        are untouched and verdicts cannot change (necessity holds
        under any ban, and anchoring only moves probe windows WITHIN
        factors)."""
        B = len(offsets) - 1
        # The measurement slab must itself be representative: a tiny
        # follow-mode batch crossing the probation threshold would
        # otherwise ban a needle factor that merely appeared in it
        # (B=1, thresh 0.5 -> one occurrence reads as "dense",
        # permanently). Keep the one-shot ARMED until a big-enough
        # slab arrives; an explicit low KLOGS_INDEX_DENSE_LINES opts
        # into smaller measurement slabs.
        if B < min(1024, self._dense_min_lines):
            return
        self._reguarded = True
        if self._dense_ratio >= 1.0:
            return
        thresh = self._dense_ratio * B
        # Aggregate hit lines PER FACTOR before thresholding: the
        # ext tier (3-byte factors) reports up to 256 separate
        # (fid, lines) tuples — one per extension code — and exactly
        # the omnipresent short guards this measurement targets would
        # otherwise slip under the threshold piecewise.
        agg: "dict[int, np.ndarray]" = {}
        for fi, lines in self.index._hits(payload, offsets):
            prev = agg.get(fi)
            agg[fi] = lines if prev is None else np.union1d(prev, lines)
        ban = {self.index.factors[fi]
               for fi, hit in agg.items() if len(hit) > thresh}
        code_freq = self._dense_codes(payload)
        if not ban and not code_freq:
            return
        from klogs_tpu_torch.filters.compiler.groups import reguard_infos
        from klogs_tpu_torch.filters.compiler.index import (
            FactorIndex,
            sweep_factor,
        )

        infos2 = (reguard_infos(
            self.infos, ignore_case=self._ignore_case,
            banned=lambda f: sweep_factor(f) in ban)
            if ban else self.infos)
        new_index = FactorIndex(infos2, self.plan,
                                code_freq=code_freq)
        if self._sweep_path == "device":
            # The re-tuned tables replace the old ones on the same card;
            # a failure raises (JAX falls back to the host sweep here).
            from klogs_tpu_torch.ops.sweep import device_sweep_tables

            self._sweep_tables = device_sweep_tables(
                new_index.sweep_program(), self._sweep_tables.device)
        self.infos = infos2
        self.index = new_index
        self.banned_factors = tuple(sorted(ban))
        if ban:
            self._m_reguard.inc(len(ban))
        from klogs_tpu_torch.ui import term

        term.info(
            "re-tuned index after %d lines: %d dense guard factor(s) "
            "banned (density > %.2f), %d dense probe code(s) "
            "re-anchored around", self.swept_lines, len(ban),
            self._dense_ratio, len(code_freq))

    @staticmethod
    def _dense_codes(payload: bytes) -> "dict[int, int]":
        """Observed-dense 4-byte codes of (a sample of) the slab: the
        re-anchor's density map. Only codes at per-line-ish density
        survive (the map stays tens of entries, not a corpus
        histogram); everything absent reads as rare."""
        cap = min(len(payload), 1 << 21)
        if cap < 4096:
            return {}
        arr = np.frombuffer(payload, dtype=np.uint8, count=cap)
        b = arr[:cap - 3].astype(np.uint32)
        code = (b | (arr[1:cap - 2].astype(np.uint32) << np.uint32(8))
                | (arr[2:cap - 1].astype(np.uint32) << np.uint32(16))
                | (arr[3:cap].astype(np.uint32) << np.uint32(24)))
        if not np.little_endian:  # match _code_at's native-order codes
            code = ((code & np.uint32(0xFF)) << np.uint32(24)
                    | (code & np.uint32(0xFF00)) << np.uint32(8)
                    | (code >> np.uint32(8)) & np.uint32(0xFF00)
                    | code >> np.uint32(24))
        vals, counts = np.unique(code, return_counts=True)
        # Keep anything near or above ~0.2% of sample positions (a few
        # hundred entries): the re-anchor compares candidate windows
        # by MINIMUM observed count, so mid-density codes (a literal
        # on 25% of lines) must be visible too, not just omnipresent
        # ones.
        keep = counts > max(8, cap >> 12)
        return {int(v): int(c)
                for v, c in zip(vals[keep], counts[keep])}

    def _device_candidates(self, payload: bytes,
                           offsets: np.ndarray) -> "np.ndarray | None":
        """Device-sweep narrowing for one slab, [B, G] bool: the payload
        and its int64 starts and lengths cross in one buffer (pinned
        for a card), ``pack_rows`` cuts the width-bucketed [rows, W]
        batch on the device (power-of-two rows and widths, as in JAX)
        and ``sweep_group_candidates`` runs over it. Returns None, and
        the host sweeps the slab, when a line is over SWEEP_MAX_WIDTH or
        the padded batch over SWEEP_MAX_BATCH_BYTES (a route by width);
        a device failure raises."""
        from klogs_tpu_torch.ops.pack import pack_rows
        from klogs_tpu_torch.ops.sweep import (
            sweep_group_candidates,
            sweep_span_attrs,
        )

        lens = np.diff(offsets).astype(np.int64)
        B = len(lens)
        wmax = int(lens.max()) if B else 0
        if wmax > SWEEP_MAX_WIDTH:
            return None
        width = 128
        while width < wmax:
            width *= 2
        rows = 8
        while rows < B:
            rows *= 2
        if rows * width > SWEEP_MAX_BATCH_BYTES:
            return None
        st = self._sweep_tables
        sp = trace.TRACER.current_span()
        if sp is not None and sp.sampled:
            for k, v in sweep_span_attrs(st).items():
                sp.set_attr(k, v)
        dev = st.device
        meta = np.zeros(2 * rows, dtype=np.int64)
        meta[:B] = offsets[:-1]
        meta[rows:rows + B] = lens
        head = meta.nbytes
        host = torch.empty(head + len(payload), dtype=torch.uint8,
                           pin_memory=dev.type == "cuda")
        buf = host.numpy()
        buf[:head] = meta.view(np.uint8)
        buf[head:] = np.frombuffer(payload, dtype=np.uint8)
        if dev.type == "cuda":
            host = host.to(dev, non_blocking=True)
        meta_t, pay_t = host[:head].view(torch.int64), host[head:]
        batch = pack_rows(pay_t, meta_t[:B], meta_t[rows:rows + B], width,
                          rows)
        gm = sweep_group_candidates(st, batch, meta_t[rows:])
        return gm[:B].cpu().numpy()


def _env_float(name: str, default: float) -> float:
    """Env override parsed strictly: a malformed value raises (silent
    misconfiguration of an adaptive knob hides real regressions). The
    shared strict dialect from klogs_tpu_torch.utils.env."""
    from klogs_tpu_torch.utils.env import nonneg_float

    return nonneg_float(name, default)


def _sweep_pipeline_depth() -> int:
    """KLOGS_SWEEP_PIPELINE -> in-flight slab count (1 = serial).

    ``auto`` (the default) keeps depth 2 on multi-core hosts and the
    serial schedule on 1-core ones: overlap needs a second core to run
    the sweep kernel's GIL-free scan beside the confirm stage; on one
    core the pipeline is pure thread-switch overhead. ``off`` (or 0/1)
    pins the serial schedule (the tests' reference). An explicit integer
    pins the depth, clamped to 4 (the win saturates at one slab of
    prefetch because the confirm stage is main-thread-bound).
    Malformed values raise — the strict dialect, same as the other
    index knobs."""
    import os

    from klogs_tpu_torch.utils.env import read

    raw = read("KLOGS_SWEEP_PIPELINE", "auto")
    val = str(raw).strip().lower()
    if val in ("off", "0", "1"):
        return 1
    if val == "auto":
        return 2 if (os.cpu_count() or 1) >= 2 else 1
    try:
        depth = int(val)
    except ValueError:
        raise ValueError(
            f"KLOGS_SWEEP_PIPELINE={raw!r}: expected auto, off, or an "
            "integer pipeline depth") from None
    if depth < 0:
        raise ValueError(
            f"KLOGS_SWEEP_PIPELINE={raw!r}: depth must be >= 0")
    return min(depth, 4)


def _gather_frame(arr: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
                  rows: np.ndarray) -> "tuple[bytes, np.ndarray]":
    """Sub-frame of ``rows`` out of a framed batch, fully vectorized:
    (payload bytes, int32 offsets). ``arr`` is the uint8 view of the
    parent payload."""
    sub_lens = lens[rows].astype(np.int64)
    # Safe outside frame_lines: the sub-frame is a subset of a parent
    # payload whose offsets already passed the int32 guard, so the
    # int64 cumsum can never exceed the parent's int32 total.
    ends = np.cumsum(sub_lens)  # klogs: ignore[int32-guard]
    total = int(ends[-1]) if len(ends) else 0
    sub_off = np.zeros(len(rows) + 1, dtype=np.int32)
    sub_off[1:] = ends.astype(np.int32)
    if not total:
        return b"", sub_off
    # Standard ragged-range trick: absolute source index for every byte.
    starts = offsets[rows].astype(np.int64)
    firsts = np.repeat(starts - np.concatenate(([0], ends[:-1])), sub_lens)
    pos = firsts + np.arange(total, dtype=np.int64)
    return arr[pos].tobytes(), sub_off
