"""The shared multi-literal index: one sweep narrows every line to its
candidate pattern groups.

A copy of ``klogs_tpu/filters/compiler/index.py``, both halves. Every
guarded pattern contributes an OR-set of mandatory literals
(factors.guard_factors); the index dedupes them across the set. A line
is a candidate for group g iff some member pattern's guard literal
occurs inside it (or g is an always-candidate group). Every guard is a
NECESSARY condition, so the gate never hides a match: false positives
cost a redundant group scan, false negatives are impossible.

One ``FactorIndex`` holds the tables of both sweeps, and they give the
SAME mask, bit for bit (tests/test_torch_indexed.py and
tests/test_torch_native.py hold them to it):

- the device sweep: ``sweep_program`` packs the ``SweepProgram`` tables
  that ``ops/sweep.py`` evaluates on the card (the GPU engine's gate,
  and the indexed engine's device narrowing);
- the host sweep of the indexed engine (``--backend cpu``):
  ``group_candidates``/``group_candidates_packed`` run
  ``sweep_candidates`` in ``native/_hostops.c`` over
  ``native_sweep_blob``, the same tables serialized behind an i32 header
  in the JAX layout (``_NATIVE_VERSION`` 2, byte for byte), plus the
  Teddy stage-1 nibble masks and the 64 KiB union bloom. The numpy sweep
  (``_hits``/``_emit``, ``group_candidates(impl="numpy")``) is its plain
  version, which only the tests run: ``KLOGS_NATIVE_SIMD=off``, which
  selects it in the JAX package, raises here.

Sweep design (host). The hot loop costs a fixed small number of passes
over the payload, independent of K; per-factor work happens only at
surviving positions:

- **One rolling code array.** A 4-byte code per payload position; a
  factor >= 8 bytes probes as a conjunction of two 4-byte half-window
  codes at distance 4.
- **Rarity-anchored windows.** Each factor's probe window sits at its
  rarest position (a static log-text prior, or observed code counts
  after the indexed engine's re-anchor), so survivors track true
  occurrences.
- **Staged gates.** Stage 1 is a SIMD shufti over the anchored windows'
  first four bytes (8 or 16 buckets, ``KLOGS_SWEEP_BUCKETS``) and the
  union bloom; survivors pay the exact two-tier hash probe and a masked
  word verify of the whole factor and the line bounds.

Factors of 3 bytes (factors.MIN_FACTOR_LEN) enter the narrow tier as
all 256 one-byte extensions (the 4th byte is verified as don't-care).
Padding only ADDS candidate positions; every survivor is verified
exactly, so the sweep over-approximates but never misses.

``multidfa_blob`` packs the DFA-backed groups' tables for the indexed
engine's batched confirm stage (``group_scan`` in ``_hostops.c``), in
the JAX layout.
"""

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np

from klogs_tpu_torch.filters.compiler.groups import GroupPlan, PatternInfo

if TYPE_CHECKING:
    from klogs_tpu_torch.filters.compiler.dfa import DFATables

# Minimum factor width the sweep can probe: matches
# factors.MIN_FACTOR_LEN (every guard literal is at least 3 bytes).
GRAM = 3
# Probe window widths: the wide tier (two chained 4-byte codes) for
# factors that fit one, the narrow tier (one code) for the rest.
WIDE = 8
NARROW = 4
# Longest factor the sweep verifies — BY DEFINITION the factor
# extractor's truncation bound (over-long guards only exist because
# guard_factors returns un-truncated exact literals): such literals
# are cut to their rarest window of this width at index build — still
# a necessary condition, and it bounds the device verify at
# SWEEP_FACTOR_CAP/4 word compares.
from klogs_tpu_torch.filters.compiler.factors import (  # noqa: E402
    MAX_FACTOR_LEN as SWEEP_FACTOR_CAP,
)
# Bloom fold width: 2^16 bytes = 64 KiB per table, cache-resident,
# ~1.5% load even at K=4096 (~one anchored code per factor) — and the
# fold is the HIGH uint16 half of a Fibonacci multiply, readable as a
# zero-copy strided view of the product array (no shift pass).
_BLOOM_BITS = 16
_FIB = 2654435761
_FIB32 = np.uint32(_FIB)

# Static rarity prior on log-like text for window anchoring, derived
# from the ONE scoring table (factors._byte_rarity: smaller = rarer).
# _anchor argmaxes a window sum, so negate — the argmax of -w is the
# window with the smallest (rarest) factors-score. One source of
# truth: a tweak to the factor prior re-anchors the sweep with it.
from klogs_tpu_torch.filters.compiler.factors import _byte_rarity

_BYTE_RARITY = np.asarray([-_byte_rarity(b) for b in range(256)],
                          dtype=np.float64)


def _anchor(f: bytes, width: int) -> int:
    """Offset of the rarest ``width``-byte window of ``f`` (the probe
    code position — see module docstring)."""
    w = _BYTE_RARITY[np.frombuffer(f, dtype=np.uint8)]
    if len(f) <= width:
        return 0
    sums = np.convolve(w, np.ones(width), mode="valid")
    return int(np.argmax(sums))


def sweep_factor(f: bytes) -> bytes:
    """The exact bytes the sweep indexes for guard literal ``f``:
    over-long literals (past SWEEP_FACTOR_CAP) are cut to their rarest
    cap-width window — a substring of a mandatory literal is itself
    mandatory. Shared by the index build and the adaptive re-guard's
    ban test (the ban must name what the sweep actually probed)."""
    if len(f) > SWEEP_FACTOR_CAP:
        at = _anchor(f, SWEEP_FACTOR_CAP)
        return f[at:at + SWEEP_FACTOR_CAP]
    return f


def _fold1(code: int) -> int:
    """Bloom-table index of one 4-byte code (build-time scalar twin of
    the sweep's vectorized multiply-fold)."""
    return ((code * _FIB) & 0xFFFFFFFF) >> (32 - _BLOOM_BITS)


def _fold(codes: np.ndarray) -> np.ndarray:
    """Bloom index per code: high half of the wrapping Fibonacci
    product, read as a zero-copy strided view on little-endian hosts
    (no shift pass)."""
    prod = codes * _FIB32
    if _LITTLE:
        return prod.view(np.uint16)[1::2]
    return (prod >> np.uint32(16)).astype(np.uint16)


_LITTLE = np.little_endian


def _code_at(f: bytes, at: int) -> int:
    """The sweep's 4-byte code of factor ``f`` at offset ``at`` —
    NATIVE byte order, matching the zero-copy payload views."""
    return int.from_bytes(f[at:at + 4].ljust(4, b"\0"),
                          "little" if _LITTLE else "big")


# -- native SIMD sweep (native/_hostops.c) ------------------------------
#
# The C sweep consumes the SAME packed tables as the device sweep
# (SweepProgram), serialized into one content-defined blob, plus the
# Teddy stage-1 nibble masks. Exact verification makes all three
# implementations (numpy / native / device) produce identical masks.
_NATIVE_MAGIC = 0x4B535750
_NATIVE_VERSION = 2
_TEDDY_M = 4
# Fat-Teddy threshold: below this many factors the 8-bucket plane is
# not saturated and the thin kernel (one shuffle chain) wins; at or
# above it the blob packs a second bucket plane (16 buckets) and the
# kernel pays one extra shuffle chain for roughly half the stage-1
# survivors. KLOGS_SWEEP_BUCKETS=8|16 pins the mode for parity
# fuzzing and A/B benches.
_FAT_FACTOR_MIN = 64
_BUCKET_CHOICES = ("auto", "8", "16")
# KLOGS_NATIVE_SIMD: stage-1 tier pin. "auto" resolves to the best CPU
# level at call time; "sse2" is an alias for the ssse3 tier (the C
# clamps to what the CPU really has, so a pin can only lower the tier:
# avx512 on a host without AVX-512 runs avx2/ssse3/scalar, never
# faults). "off", which selects the numpy sweep in the JAX package,
# raises here (native_simd_level).
_SIMD_CHOICES: "dict[str, int | None]" = {
    "auto": -1, "avx512": 3, "avx2": 2, "ssse3": 1, "sse2": 1,
    "scalar": 0, "off": None,
}


def native_sweep_buckets(n_factors: int) -> int:
    """Resolved stage-1 bucket count (8 or 16) for an index with
    ``n_factors`` factors: KLOGS_SWEEP_BUCKETS when pinned, else the
    _FAT_FACTOR_MIN threshold (strict dialect — a typo'd pin silently
    benching the wrong bucket mode would poison every A/B row)."""
    from klogs_tpu_torch.utils.env import read

    raw = read("KLOGS_SWEEP_BUCKETS", "auto") or "auto"
    mode = raw.strip().lower()
    if mode not in _BUCKET_CHOICES:
        raise ValueError(
            f"KLOGS_SWEEP_BUCKETS={raw!r}: expected one of "
            f"{', '.join(_BUCKET_CHOICES)}")
    if mode == "auto":
        return 16 if n_factors >= _FAT_FACTOR_MIN else 8
    return int(mode)

# KLOGS_NATIVE_GROUPSCAN: the batched MultiDFA group-scan stage of the
# indexed engine (group_scan in _hostops.c). "auto" and "native" both
# run the C; "off", which selects the per-group loop (the plain
# version) in the JAX package, raises here.
_GROUPSCAN_CHOICES = ("auto", "native", "off")


def native_groupscan_mode() -> str:
    """Parsed KLOGS_NATIVE_GROUPSCAN: always ``"auto"`` (the C group
    scan). A malformed value raises naming the knob, and so does
    ``off``: the per-group loop is the plain version, which only the
    tests run."""
    from klogs_tpu_torch.utils.env import read

    raw = (read("KLOGS_NATIVE_GROUPSCAN", "auto") or "auto")
    mode = raw.strip().lower()
    if mode not in _GROUPSCAN_CHOICES:
        raise ValueError(
            f"KLOGS_NATIVE_GROUPSCAN={raw!r}: expected one of "
            f"{', '.join(_GROUPSCAN_CHOICES)}")
    if mode == "off":
        raise ValueError(
            "KLOGS_NATIVE_GROUPSCAN=off would confirm on the per-group "
            "loop, the plain version of the C group_scan; the port runs "
            "the C only (unset it, or use auto)")
    return "auto"


# -- MultiDFA program blob (native batched group scan) -----------------
#
# The confirm-stage twin of native_sweep_blob(): every DFA-backed
# group's flat scan tables (DFATables from compiler/dfa.py), packed
# behind one validated header so group_scan in _hostops.c can walk the
# whole candidate matrix in ONE GIL-released call. Unlike the sweep
# blob the tables here can run to several MB, so the blob stays in
# NATIVE byte order and is strictly process-local (built and consumed
# in the same process, never persisted or sent anywhere) — no
# byte-swapping pass is ever paid. The build is content-defined
# (a pure function of the member tables); IndexedFilter caches it
# keyed by member-table identity and rebuilds only when a member's
# tables object changes (e.g. the DFA LRU refreshed it), reusing the
# bytes of unchanged members via ``chunks``.
_MDFA_MAGIC = 0x4B4D4446
_MDFA_VERSION = 1
_MDFA_HEADER_WORDS = 8
_MDFA_DESC_WORDS = 10


def multidfa_blob(tables: "list[DFATables]",
                  chunks: "dict[int, tuple[bytes, bytes, bytes]] | None"
                  = None) -> bytes:
    """Pack ``tables`` (one DFATables per program member, in candidate-
    matrix column order) into the MultiDFA program blob.

    Layout (i32 words, native order; mirrored by the MH_*/MD_* enums
    in _hostops.c): an 8-word header (magic, version, member count,
    total length, 4 reserved), then per member a 10-word descriptor
    (n_dfa, n_classes, start, end_class, wide, match_all, and 4-byte-
    aligned offsets of the row-major transition table, the accept
    flags, and the int32[256] byte->class map), then the concatenated
    arrays. ``chunks`` (keyed by ``id(table_set)``) caches each
    member's serialized arrays so an incremental rebuild re-serializes
    only refreshed members."""
    if not tables:
        raise ValueError("multidfa_blob needs at least one table set")
    M = len(tables)
    header = np.zeros(_MDFA_HEADER_WORDS + _MDFA_DESC_WORDS * M,
                      dtype=np.int32)
    parts: "list[bytes]" = []
    pos = header.nbytes

    def put(b: bytes) -> int:
        nonlocal pos
        at = pos
        parts.append(b)
        pos += len(b)
        pad = (-pos) % 4
        if pad:
            parts.append(bytes(pad))
            pos += pad
        return at

    for m, t in enumerate(tables):
        cached = chunks.get(id(t)) if chunks is not None else None
        if cached is None:
            cached = (np.ascontiguousarray(t.table).tobytes(),
                      np.ascontiguousarray(t.accept,
                                           dtype=np.uint8).tobytes(),
                      np.ascontiguousarray(t.byte_class,
                                           dtype=np.int32).tobytes())
            if chunks is not None:
                chunks[id(t)] = cached
        d = _MDFA_HEADER_WORDS + _MDFA_DESC_WORDS * m
        header[d + 0] = len(t.accept)
        header[d + 1] = t.n_classes
        header[d + 2] = t.start
        header[d + 3] = t.end_class
        header[d + 4] = 1 if t.table.dtype == np.uint32 else 0
        header[d + 5] = 1 if t.match_all else 0
        header[d + 6] = put(cached[0])
        header[d + 7] = put(cached[1])
        header[d + 8] = put(cached[2])
    header[0] = _MDFA_MAGIC
    header[1] = _MDFA_VERSION
    header[2] = M
    header[3] = pos
    blob = header.tobytes() + b"".join(parts)
    assert len(blob) == pos
    return blob


def native_simd_level() -> int:
    """Parsed KLOGS_NATIVE_SIMD: -1 auto, 0/1/2/3 a pinned stage-1
    tier (scalar/ssse3/avx2/avx512). A malformed value raises naming
    the knob, and so does ``off``: the numpy sweep it selects in the
    JAX package is the plain version here, which only the tests run."""
    from klogs_tpu_torch.utils.env import read

    raw = read("KLOGS_NATIVE_SIMD", "auto") or "auto"
    try:
        level = _SIMD_CHOICES[raw.strip().lower()]
    except KeyError:
        raise ValueError(
            f"KLOGS_NATIVE_SIMD={raw!r}: expected one of "
            f"{', '.join(sorted(_SIMD_CHOICES))}") from None
    if level is None:
        raise ValueError(
            "KLOGS_NATIVE_SIMD=off would narrow on the numpy sweep, the "
            "plain version of the C sweep_candidates; the port runs the "
            "C only (unset it, use auto, or pin a tier: scalar, ssse3, "
            "avx2, avx512)")
    return level


@dataclass
class SweepStats:
    """Narrowing outcome of one swept batch (observability)."""

    lines: int = 0
    groups: int = 0
    candidate_cells: int = 0  # candidate (line, group) scan units
    candidate_lines: int = 0  # lines with at least one candidate group
    # Per-group candidate counts of the batch ([G] int64, None when
    # not tallied): the engine's group-scan ordering reuses this
    # instead of re-reducing the multi-MB candidate matrix.
    col_cells: "np.ndarray | None" = None

    @property
    def narrowing_ratio(self) -> float:
        """Fraction of (line, group) scans the index could NOT rule
        out: 1.0 = no narrowing (scan everything), 0.0 = nothing to
        scan. Lower is better."""
        total = self.lines * self.groups
        return (self.candidate_cells / total) if total else 1.0


class _Tier:
    """Exact-code probe tables for one tier: entries are (code, fid,
    anchor) sorted by code, bucketed so entries sharing a code form
    one contiguous run."""

    def __init__(self, entries: "list[tuple[int, int, int]]") -> None:
        entries.sort()
        codes = np.asarray([e[0] for e in entries], dtype=np.uint64)
        self.fid = np.asarray([e[1] for e in entries], dtype=np.int64)
        self.anchor = np.asarray([e[2] for e in entries], dtype=np.int64)
        self.codes, starts = np.unique(codes, return_index=True)
        self.bucket_start = np.append(starts, len(entries))


class FactorIndex:
    """Compiled sweep tables for one analyzed, grouped pattern set.

    ``code_freq`` (optional, {native-endian 4-byte code: observed
    count}) feeds the adaptive RE-ANCHOR: probe windows are normally
    placed by the static log-text rarity prior, but the prior can
    misfire on a live corpus — a factor like ``errcode=00881`` anchored
    on its ``code`` window pays a bloom hit + hash probe at EVERY
    ``code=`` occurrence even though the full factor never verifies.
    When observed counts are supplied (the IndexedFilter measures them
    on the probation slab), each factor's window minimizes the
    OBSERVED density first and falls back to the static prior as the
    tie-break. Anchoring only moves the probe window WITHIN the
    factor, so necessity — and numpy/native/device mask parity, since
    all three consume tables built from the same anchors — is
    untouched."""

    def __init__(self, infos: "list[PatternInfo]", plan: GroupPlan,
                 code_freq: "dict[int, int] | None" = None) -> None:
        self._code_freq = code_freq or {}
        self.n_patterns = len(infos)
        self.n_groups = plan.n_groups
        # Always-candidate groups: the plan's (groups packed from
        # unguardable patterns) PLUS any group holding a pattern whose
        # info carries no guard — under an adaptive re-guard ban
        # (groups.reguard_infos) a member of a guarded-plan group can
        # lose its guard, and its whole group must then be a candidate
        # for every line or necessity breaks.
        always = set(int(g) for g in plan.always_groups)
        for info in infos:
            if info.guard is None:
                always.add(int(plan.group_of[info.index]))
        self.always_groups = np.asarray(sorted(always), dtype=np.int64)
        # Dedupe guard literals across the set; remember, per literal,
        # which patterns it guards (for the per-pattern matrix) and
        # which groups those patterns live in (for the group sweep).
        by_factor: "dict[bytes, list[int]]" = {}
        for info in infos:
            for f in info.guard or ():
                # Over-long factors (un-truncated exact literals) sweep
                # as their rarest SWEEP_FACTOR_CAP-byte window
                # (sweep_factor): a substring of a mandatory literal
                # is itself mandatory, so necessity is preserved, and
                # the cap bounds the verify word count on BOTH the
                # host and device paths (the two must verify identical
                # bytes for the device mask to equal the host mask bit
                # for bit).
                by_factor.setdefault(sweep_factor(f),
                                     []).append(info.index)
        self.factors: "list[bytes]" = sorted(by_factor)
        self.pattern_ids: "list[np.ndarray]" = [
            np.asarray(by_factor[f], dtype=np.int64) for f in self.factors]
        self.group_ids: "list[np.ndarray]" = [
            np.unique(plan.group_of[pids]).astype(np.int64)
            for pids in self.pattern_ids]
        self._factor_arrs = [
            np.frombuffer(f, dtype=np.uint8) for f in self.factors]
        # Guarded = appears in some factor's pattern set (every guard
        # member lists its patterns, so any guarded pattern is covered).
        # The complement drives always-candidate masks for BOTH the
        # plan-group sweep and any re-targeted device sweep program.
        self.guarded = np.zeros(self.n_patterns, dtype=bool)
        for pids in self.pattern_ids:
            self.guarded[pids] = True
        self._group_of = np.asarray(plan.group_of, dtype=np.int32)
        self._sweep_prog: "Optional[SweepProgram]" = None
        # Keyed by bucket count (8/16): fuzzing and A/B benches pin
        # KLOGS_SWEEP_BUCKETS between calls on one index, so each
        # resolved mode keeps its own immutable blob.
        self._native_blobs: "dict[int, bytes]" = {}
        # Which implementation produced the last group_candidates mask
        # ("native", or "numpy" when a test asked for the plain version).
        self.last_impl = "native"
        # Stage-1 survivor telemetry of the last C sweep
        # ({"survivors", "positions"}; None before the first one).
        self.last_sweep_stats: "Optional[dict[str, int]]" = None

        # Stage-1 union bloom (one gather gates everything) + per-tier
        # discrimination blooms consulted only at surviving positions.
        self._bloom_u = np.zeros(1 << _BLOOM_BITS, dtype=np.uint8)
        self._bloom_a = np.zeros(1 << _BLOOM_BITS, dtype=np.uint8)
        self._bloom_b = np.zeros(1 << _BLOOM_BITS, dtype=np.uint8)
        self._bloom_n = np.zeros(1 << _BLOOM_BITS, dtype=np.uint8)
        # THE per-factor probe decision (tier + window anchor),
        # computed ONCE and consulted by every table builder — the
        # host tiers here, the native blob's teddy masks, and the
        # device SweepProgram — so no two implementations can ever
        # disagree on where a factor's window sits. A >= WIDE factor
        # normally probes the wide tier, but under observed densities
        # it DEMOTES to the narrow tier when its best 4-byte window is
        # rarer than its best 8-byte window HEAD ("ms code=418": every
        # 8B window starts in omnipresent template text, while the
        # narrow "=418" window is needle-rare). The verify is always
        # the full factor, so tier choice is purely a probe-cost
        # decision.
        self._probes: "list[tuple[str, int]]" = []
        for f in self.factors:
            if len(f) < NARROW:
                self._probes.append(("ext", 0))
            elif len(f) < WIDE:
                self._probes.append(
                    ("narrow", self._anchor_of(f, NARROW)))
            else:
                wat = self._anchor_of(f, WIDE)
                tier, at = "wide", wat
                if self._code_freq:
                    nat = self._anchor_of(f, NARROW)
                    if (self._code_freq.get(_code_at(f, nat), 0)
                            < self._code_freq.get(_code_at(f, wat), 0)):
                        tier, at = "narrow", nat
                self._probes.append((tier, at))
        wide_entries: "list[tuple[int, int, int]]" = []
        narrow_entries: "list[tuple[int, int, int]]" = []
        for fi, f in enumerate(self.factors):
            tier, at = self._probes[fi]
            if tier == "wide":
                hi, lo = _code_at(f, at), _code_at(f, at + 4)
                self._bloom_u[_fold1(hi)] = 1
                self._bloom_a[_fold1(hi)] = 1
                self._bloom_b[_fold1(lo)] = 1
                wide_entries.append(((hi << 32) | lo, fi, at))
            elif tier == "narrow":
                code = _code_at(f, at)
                self._bloom_u[_fold1(code)] = 1
                self._bloom_n[_fold1(code)] = 1
                narrow_entries.append((code, fi, at))
            else:
                # 3-byte factor: all 256 one-byte extensions (module
                # docstring) — the 4th byte is don't-care at verify.
                for ext in range(256):
                    code = _code_at(f + bytes([ext]), 0)
                    self._bloom_u[_fold1(code)] = 1
                    self._bloom_n[_fold1(code)] = 1
                    narrow_entries.append((code, fi, 0))
        self._wide = _Tier(wide_entries) if wide_entries else None
        self._narrow = _Tier(narrow_entries) if narrow_entries else None
        self.last_stats = SweepStats()

    @property
    def n_factors(self) -> int:
        return len(self.factors)

    def _anchor_of(self, f: bytes, width: int) -> int:
        """Probe-window offset for factor ``f``: observed corpus
        density first (class docstring), static rarity prior as the
        tie-break — or the prior alone when no observations exist.
        EVERY window consumer (tier build, teddy masks, device
        program) anchors through here so the implementations can
        never disagree on where a factor's window sits."""
        if not self._code_freq or len(f) <= width:
            return _anchor(f, width)
        w = _BYTE_RARITY[np.frombuffer(f, dtype=np.uint8)]
        sums = np.convolve(w, np.ones(width), mode="valid")
        best = 0
        best_key: "tuple[int, float] | None" = None
        for o in range(len(f) - width + 1):
            # Stage 1 (teddy + union bloom) gates on the window's
            # FIRST 4 bytes, so that code's observed count is the
            # survivor-cost driver for both tiers.
            key = (self._code_freq.get(_code_at(f, o), 0),
                   -float(sums[o]))
            if best_key is None or key < best_key:
                best_key, best = key, o
        return best

    # -- the sweep ----------------------------------------------------

    def _stage1(self, buf: bytes, n: int) -> np.ndarray:
        """Surviving positions of the stage-1 union-bloom gate, lane
        by lane: each byte offset k in 0..3 yields a zero-copy 4-byte
        view of the padded payload, whose fold gathers straight into
        the interleaved hit mask — the full per-position code array is
        never materialized (survivors recompute their exact codes from
        the raw bytes, O(survivors))."""
        g = np.empty(n, dtype=np.uint8)
        for k in range(4):
            lane = g[k::4]
            v = np.frombuffer(buf, dtype="<u4" if _LITTLE else ">u4",
                              offset=k, count=(len(buf) - k) // 4)
            lane[:] = self._bloom_u[_fold(v)[:len(lane)]]
        return np.nonzero(g)[0]

    @staticmethod
    def _codes_at(buf_arr: np.ndarray, s: np.ndarray) -> np.ndarray:
        """Native-endian 4-byte codes of positions ``s`` (vectorized
        over survivors; ``buf_arr`` is the padded payload bytes)."""
        b0 = buf_arr[s].astype(np.uint32)
        b1 = buf_arr[s + 1].astype(np.uint32)
        b2 = buf_arr[s + 2].astype(np.uint32)
        b3 = buf_arr[s + 3].astype(np.uint32)
        if _LITTLE:
            return (b0 | (b1 << np.uint32(8)) | (b2 << np.uint32(16))
                    | (b3 << np.uint32(24)))
        return ((b0 << np.uint32(24)) | (b1 << np.uint32(16))
                | (b2 << np.uint32(8)) | b3)

    def _hits(self, payload: bytes,
              offsets: np.ndarray) -> "list[tuple[int, np.ndarray]]":
        """(factor_id, line_ids) for every factor occurring inside a
        line of the framed batch. A fixed number of vectorized passes
        over the payload; Python iteration only over DISTINCT PRESENT
        codes (rare on a needle corpus) and their bucket factors."""
        arr = np.frombuffer(payload, dtype=np.uint8)
        n = len(arr)
        out: "list[tuple[int, np.ndarray]]" = []
        if n < GRAM or (self._wide is None and self._narrow is None):
            return out
        buf = bytes(payload) + bytes(8)  # payload may be a memoryview
        buf_arr = np.frombuffer(buf, dtype=np.uint8)
        # Stage 1: one union-bloom gather + one nonzero over the whole
        # payload; everything tier-specific runs on survivors only.
        s = self._stage1(buf, n)
        if not len(s):
            return out
        cs = self._codes_at(buf_arr, s)
        fs = _fold(cs)
        if self._wide is not None:
            wm = self._bloom_a[fs].astype(bool)
            ws = s[wm]
            if len(ws):
                lo = self._codes_at(buf_arr, ws + NARROW)
                bm = self._bloom_b[_fold(lo)].astype(bool)
                ws, lo = ws[bm], lo[bm]
                if len(ws):
                    exact = ((cs[wm][bm].astype(np.uint64)
                              << np.uint64(32)) | lo)
                    self._emit(self._wide, ws, exact, arr, n, offsets,
                               out)
        if self._narrow is not None:
            nm = self._bloom_n[fs].astype(bool)
            ns = s[nm]
            if len(ns):
                self._emit(self._narrow, ns, cs[nm].astype(np.uint64),
                           arr, n, offsets, out)
        return out

    def _emit(self, tier: _Tier, s: np.ndarray, exact: np.ndarray,
              arr: np.ndarray, n: int, offsets: np.ndarray,
              out: "list[tuple[int, np.ndarray]]") -> None:
        """Resolve bloom survivors ``s`` (exact codes ``exact``)
        against one tier's tables and append verified (fid, lines)."""
        slot = np.searchsorted(tier.codes, exact)
        slot_c = np.minimum(slot, len(tier.codes) - 1)
        ok = tier.codes[slot_c] == exact
        pos, kid = s[ok], slot_c[ok]
        if not len(pos):
            return
        # Sorted-run extraction: one stable argsort groups hit
        # positions by code; runs slice out per distinct code
        # (positions stay ascending within a run).
        order = np.argsort(kid, kind="stable")
        pos, kid = pos[order], kid[order]
        run_at = np.flatnonzero(np.diff(kid)) + 1
        bounds = np.concatenate(([0], run_at, [len(kid)]))
        for r in range(len(bounds) - 1):
            k = int(kid[bounds[r]])
            at = pos[bounds[r]:bounds[r + 1]]
            for bi in range(int(tier.bucket_start[k]),
                            int(tier.bucket_start[k + 1])):
                fi = int(tier.fid[bi])
                fa = self._factor_arrs[fi]
                L = len(fa)
                # Window position -> factor start; verify the FULL
                # factor bytes (window included: survivors may be
                # bloom false positives) and the line bounds.
                q = at - int(tier.anchor[bi])
                q = q[(q >= 0) & (q + L <= n)]
                if len(q):
                    body = arr[q[:, None] + np.arange(L)[None, :]]
                    q = q[(body == fa[None, :]).all(axis=1)]
                if not len(q):
                    continue
                line = np.searchsorted(offsets, q, side="right") - 1
                inside = (line >= 0) & (q + L <= offsets[line + 1])
                if inside.any():
                    out.append((fi, np.unique(line[inside])))

    def group_candidates(self, payload: bytes, offsets: np.ndarray,
                         impl: "str | None" = None) -> np.ndarray:
        """[B, G] bool: True where the line might match a pattern of
        group g (necessary condition). Always-candidate groups are True
        everywhere. Updates ``last_stats`` with the narrowing outcome.

        ``impl`` None or ``"native"`` runs the C sweep
        (``sweep_candidates``); ``"numpy"`` runs its plain version,
        which only the tests ask for. ``last_impl`` records what ran."""
        if impl not in (None, "native", "numpy"):
            raise ValueError(
                f"impl={impl!r}: expected native, numpy or None")
        B = len(offsets) - 1
        if impl == "numpy":
            self.last_impl = "numpy"
            gm = np.zeros((B, self.n_groups), dtype=bool)
            if len(self.always_groups):
                gm[:, self.always_groups] = True
            for fi, lines in self._hits(payload, offsets):
                gm[np.ix_(lines, self.group_ids[fi])] = True
            colsums = gm.sum(axis=0, dtype=np.int64)
            cand_lines = (B if B and len(colsums)
                          and int(colsums.max()) == B
                          else int(gm.any(axis=1).sum()) if B else 0)
            self.last_stats = SweepStats(
                lines=B, groups=self.n_groups,
                candidate_cells=int(colsums.sum()),
                candidate_lines=cand_lines, col_cells=colsums)
            return gm
        bits = self.group_candidates_packed(payload, offsets)
        # count= keeps the unpack a single contiguous [B, G] pass and
        # the bool view is free.
        return np.unpackbits(bits.view(np.uint8), axis=1,
                             bitorder="little",
                             count=self.n_groups).view(bool)

    def native_ready(self) -> bool:
        """True: the C sweep serves every ``group_candidates`` call
        (callers size slabs by it: filters/indexed.py
        NATIVE_SLAB_LINES). Builds the C module at first use, so a
        failed build, like ``KLOGS_NATIVE_SIMD=off``, raises here."""
        from klogs_tpu_torch.native import hostops

        native_simd_level()
        hostops()
        return True

    def group_candidates_packed(self, payload: bytes,
                                offsets: np.ndarray) -> np.ndarray:
        """The C sweep's RAW u32[B, ceil(G/32)] group bitset (bit g&31 of
        word g>>5 = group g candidacy, always-candidate bits pre-set),
        with the same ``last_stats``/``last_impl`` bookkeeping as the
        bool form. The packed words feed the C group_scan's packed mode
        zero-copy, so no per-slab unpack runs on the engine's path."""
        return self.adopt_sweep(
            self.sweep_packed_stateless(payload, offsets),
            len(offsets) - 1)

    def sweep_packed_stateless(self, payload: bytes,
                               offsets: np.ndarray) -> tuple:
        """One C sweep with NO shared-state side effects: returns (bits
        u32[B, W], colsums i64[G], cand_lines, survivors, positions).

        This is the slab pipeline's prefetch stage (filters/indexed.py):
        a worker thread may run it on slab i+1 while the main thread
        confirms slab i. The program blob is immutable bytes, the stats
        buffer is call-local, and the C releases the GIL for the whole
        scan, so the only ordering rule left is that the CALLER folds
        results into ``last_stats`` in slab order (``adopt_sweep``)."""
        from klogs_tpu_torch.native import hostops

        level = native_simd_level()
        off = np.ascontiguousarray(offsets, dtype=np.int32)
        B = len(off) - 1
        W = (self.n_groups + 31) // 32
        if B <= 0:
            return (np.zeros((0, W), dtype="<u4"),
                    np.zeros(self.n_groups, dtype=np.int64), 0, 0, 0)
        # Call-local stats buffer u64[3 + 32*W]: [survivors, positions,
        # candidate lines, per-bit column sums]; the C folds the column
        # reduction into its walk of the packed mask.
        stats = np.zeros(3 + 32 * W, dtype=np.uint64)
        raw = hostops().sweep_candidates(
            self.native_sweep_blob(), payload, off, B, int(level), stats)
        return (np.frombuffer(raw, dtype="<u4").reshape(B, -1),
                stats[3:3 + self.n_groups].astype(np.int64),
                int(stats[2]), int(stats[0]), int(stats[1]))

    def adopt_sweep(self, res: tuple, B: int) -> np.ndarray:
        """Fold a ``sweep_packed_stateless`` result into the index's
        bookkeeping (``last_stats``/``last_impl``/``last_sweep_stats``):
        called on the MAIN thread in slab order, so pipelined stats are
        identical to the serial schedule's. Returns the packed bits."""
        bits, colsums, cand_lines, survivors, positions = res
        self.last_sweep_stats = {"survivors": survivors,
                                 "positions": positions}
        self.last_impl = "native"
        self.last_stats = SweepStats(
            lines=B, groups=self.n_groups,
            candidate_cells=int(colsums.sum()),
            candidate_lines=cand_lines,
            col_cells=colsums)
        return bits

    def native_sweep_blob(self) -> bytes:
        """The native kernel's table blob: the default SweepProgram's
        arrays serialized little-endian behind a fixed i32 header
        (offsets into the blob; layout mirrored by the enums at the
        top of the sweep section in _hostops.c), plus the Teddy
        stage-1 nibble masks — _TEDDY_M (4) window bytes x {low, high}
        nibble x 16 entries of bucket bitmasks per plane (128 bytes) —
        and the 64 KiB union bloom. Big indexes (see
        ``native_sweep_buckets``) pack a SECOND bucket plane: 16
        buckets split across two independent AND-chains, header words
        SH_BUCKETS/SH_TEDDY2_OFF, version 2. Cached per resolved
        bucket mode like ``_sweep_prog``; the blob is plain bytes, so
        it is immutable and thread-shareable by construction."""
        buckets = native_sweep_buckets(len(self.factors))
        cached = self._native_blobs.get(buckets)
        if cached is not None:
            return cached
        prog = self.sweep_program()
        # Stage-1 tables: 4-deep Teddy nibble masks over each factor's
        # anchored window (a 3-byte factor's 4th window byte is the
        # don't-care extension -> wildcard in position 3), plus the
        # union bloom (fold16 of every probe code of both tiers) the
        # confirm consults before any hash probe.
        #
        # Bucket assignment clusters factor families: factors are
        # ranked by their DISTINCT window bytes (sorted, so shared
        # guard-literal prefixes from groups.py land adjacent) and the
        # rank range is cut into equal bucket slices. Identical
        # windows always share a bucket, and unrelated families stop
        # diluting each other's nibble predicates — the confirm stage
        # verifies exactly, so assignment only moves the stage-1
        # false-positive rate, never the mask.
        teddy = np.zeros((2, _TEDDY_M, 2, 16), dtype=np.uint8)
        bloom = np.zeros(1 << _BLOOM_BITS, dtype=np.uint8)
        windows = [f[at:at + _TEDDY_M]
                   for (tier, at), f in zip(self._probes, self.factors)]
        rank = {w: i for i, w in enumerate(sorted(set(windows)))}
        n_win = max(1, len(rank))
        for fi, f in enumerate(self.factors):
            tier, at = self._probes[fi]
            w = windows[fi]
            plane, bit = divmod(rank[w] * buckets // n_win, 8)
            bucket = np.uint8(1 << bit)
            for j in range(_TEDDY_M):
                if j < len(w):
                    teddy[plane, j, 0, w[j] & 15] |= bucket
                    teddy[plane, j, 1, w[j] >> 4] |= bucket
                else:
                    teddy[plane, j, 0, :] |= bucket
                    teddy[plane, j, 1, :] |= bucket
            # Probe codes are the LITTLE-endian window codes of the
            # packed tiers (sweep_program's le_code), independent of
            # host byte order — same fold as the kernel's confirm.
            if tier != "ext":
                code = int.from_bytes(f[at:at + 4].ljust(4, b"\0"),
                                      "little")
                bloom[((code * _FIB) & 0xFFFFFFFF) >> 16] = 1
            else:
                for ext in range(256):
                    code = int.from_bytes(f + bytes([ext]), "little")
                    bloom[((code * _FIB) & 0xFFFFFFFF) >> 16] = 1

        header = np.zeros(34, dtype=np.int32)
        parts: "list[bytes]" = []
        pos = len(header.tobytes())

        def put(arr: np.ndarray, dt: str) -> int:
            nonlocal pos
            b = np.ascontiguousarray(arr, dtype=dt).tobytes()
            at = pos
            parts.append(b)
            pos += len(b)
            pad = (-pos) % 4
            if pad:
                parts.append(bytes(pad))
                pos += pad
            return at

        header[0] = _NATIVE_MAGIC
        header[1] = _NATIVE_VERSION
        header[2] = len(prog.fac_len)
        header[3] = prog.fac_words.shape[1]
        header[4] = len(prog.always_mask)
        header[5] = prog.n_groups
        header[6] = put(teddy[0].reshape(-1), "u1")
        header[7] = put(bloom, "u1")
        header[8] = put(prog.always_mask, "<u4")
        header[9] = put(prog.fac_len, "<i4")
        header[10] = put(prog.fac_words.reshape(-1), "<u4")
        header[11] = put(prog.fac_wmask.reshape(-1), "<u4")
        header[12] = put(prog.fac_groups.reshape(-1), "<u4")
        for base, tier in ((13, prog.narrow), (22, prog.wide)):
            header[base + 0] = len(tier.slot_key)
            header[base + 1] = len(tier.keys)
            header[base + 2] = len(tier.fid) if len(tier.keys) else 0
            header[base + 3] = tier.max_probe
            header[base + 4] = put(tier.slot_key, "<u4")
            header[base + 5] = put(tier.slot_eid, "<i4")
            header[base + 6] = put(tier.bucket_start, "<i4")
            header[base + 7] = put(tier.fid, "<i4")
            header[base + 8] = put(tier.anchor, "<i4")
        header[32] = buckets
        # The parser REQUIRES a zero second-plane offset in 8-bucket
        # mode (abi-conformance: no packed-but-unread words).
        header[33] = put(teddy[1].reshape(-1), "u1") if buckets == 16 else 0
        header[31] = pos
        blob = header.astype("<i4").tobytes() + b"".join(parts)
        assert len(blob) == pos
        self._native_blobs[buckets] = blob
        return blob

    def pattern_candidates(self, payload: bytes,
                           offsets: np.ndarray) -> np.ndarray:
        """[B, P] bool per-pattern candidate matrix (unguarded patterns
        all-True). The fine-grained form — tests assert its
        necessary-safety; the production scan path uses the coarser
        group matrix."""
        B = len(offsets) - 1
        pm = np.zeros((B, self.n_patterns), dtype=bool)
        pm[:, ~self.guarded] = True
        for fi, lines in self._hits(payload, offsets):
            pm[np.ix_(lines, self.pattern_ids[fi])] = True
        return pm

    # -- device sweep compilation ------------------------------------

    def sweep_program(self, group_of: "np.ndarray | None" = None,
                      n_groups: "int | None" = None) -> "SweepProgram":
        """Pack this index into the device sweep tables.

        ``group_of`` retargets the factor -> group mapping: the default
        (None) packs against this index's own plan groups, while the
        engine passes the grouped program's ``pattern_group`` map so the
        mask gates (block, kernel-group) cells directly. Groups holding
        any unguarded pattern land in ``always_mask`` under either
        mapping.

        Factors >= WIDE key on the mix of their two chained half-window
        codes (hi * FIB ^ lo, one u32 key; collisions only deepen a
        bucket, the exact verify keeps the mask exact), shorter factors
        on their single narrow code. Factor bytes are packed as
        little-endian u32 words + byte masks, so the verify compares
        against the rolling code array itself. Codes are little-endian
        whatever the host's byte order. The default-map program is
        built once and cached."""
        default = group_of is None and n_groups is None
        if default and self._sweep_prog is not None:
            return self._sweep_prog
        gof = (self._group_of if group_of is None
               else np.asarray(group_of, dtype=np.int32))
        if len(gof) != self.n_patterns:
            raise ValueError(
                f"group_of maps {len(gof)} patterns, index has "
                f"{self.n_patterns}")
        G = int(n_groups) if n_groups is not None else (
            int(gof.max()) + 1 if len(gof) else 1)
        G = max(G, 1)
        GW = (G + 31) // 32
        always = np.zeros(GW, dtype=np.uint32)
        for p in np.nonzero(~self.guarded)[0]:
            g = int(gof[p])
            always[g // 32] |= np.uint32(1 << (g % 32))

        F = len(self.factors)
        kmax = max((len(f) for f in self.factors), default=1)
        n_words = (kmax + 3) // 4
        fac_len = np.zeros(max(F, 1), dtype=np.int32)
        fac_words = np.zeros((max(F, 1), n_words), dtype=np.uint32)
        fac_wmask = np.zeros((max(F, 1), n_words), dtype=np.uint32)
        fac_groups = np.zeros((max(F, 1), GW), dtype=np.uint32)
        # (key, fid, anchor) per tier.
        narrow: "list[tuple[int, int, int]]" = []
        wide: "list[tuple[int, int, int]]" = []

        def le_code(w: bytes) -> int:
            return int.from_bytes(w.ljust(4, b"\0"), "little")

        for fi, f in enumerate(self.factors):
            fac_len[fi] = len(f)
            for j in range(0, len(f), 4):
                w = f[j : j + 4]
                fac_words[fi, j // 4] = le_code(w)
                fac_wmask[fi, j // 4] = (1 << (8 * len(w))) - 1
            for g in np.unique(gof[self.pattern_ids[fi]]):
                fac_groups[fi, int(g) // 32] |= np.uint32(
                    1 << (int(g) % 32))
            tier, at = self._probes[fi]
            if tier == "wide":
                hi, lo = le_code(f[at : at + 4]), le_code(f[at + 4 : at + 8])
                wide.append((((hi * _FIB) & 0xFFFFFFFF) ^ lo, fi, at))
            elif tier == "narrow":
                narrow.append((le_code(f[at : at + 4]), fi, at))
            else:
                # 3-byte factor: all 256 one-byte extensions, anchor 0
                # (the device pads each row with zero columns, so the
                # extension byte exists even at the line's very end).
                for ext in range(256):
                    narrow.append((le_code(f + bytes([ext])), fi, 0))

        n_tier = pack_sweep_tier(narrow)
        w_tier = pack_sweep_tier(wide)
        # Per-tier verify bound: each tier's word loop runs only as deep
        # as its own longest member.
        n_tier.n_words = max(
            (int(fac_len[fi]) + 3) // 4 for _, fi, _ in narrow) if narrow \
            else 0
        w_tier.n_words = max(
            (int(fac_len[fi]) + 3) // 4 for _, fi, _ in wide) if wide \
            else 0
        prog = SweepProgram(
            narrow=n_tier, wide=w_tier,
            fac_len=fac_len, fac_words=fac_words, fac_wmask=fac_wmask,
            fac_groups=fac_groups, always_mask=always, n_groups=G)
        if default:
            self._sweep_prog = prog
        return prog


def pack_sweep_tier(entries: "list[tuple[int, int, int]]",
                    hash_size: "int | None" = None) -> "SweepTier":
    """Pack one probe tier's (key, fid, anchor) entries: sorted unique
    keys with bucketed entry runs, plus the open-addressed hash table
    the device probes (``max_probe`` independent gathers instead of a
    binary search's dependent rounds). ``hash_size`` forces the table
    size (a power of two); linear probing, keys unique."""
    entries = sorted(entries)
    keys_all = np.asarray([e[0] for e in entries], dtype=np.uint64)
    fid = np.asarray([e[1] for e in entries] or [0], dtype=np.int32)
    anchor = np.asarray([e[2] for e in entries] or [0], dtype=np.int32)
    keys, starts = np.unique(keys_all, return_index=True)
    bucket_start = np.append(starts, len(entries)).astype(np.int32)
    max_bucket = int(np.diff(bucket_start).max()) if len(keys) else 0
    H = hash_size if hash_size is not None else _sweep_hash_size(len(keys))
    if H & (H - 1) or H < len(keys):
        raise ValueError(f"hash_size {H} not a power of two >= {len(keys)}")
    bits = H.bit_length() - 1
    slot_key = np.zeros(H, dtype=np.uint32)
    slot_eid = np.full(H, -1, dtype=np.int32)
    max_probe = 0
    for eid, k in enumerate(keys):
        h = ((int(k) * _FIB) & 0xFFFFFFFF) >> (32 - bits)
        j = 0
        while slot_eid[(h + j) & (H - 1)] >= 0:
            j += 1
        slot_key[(h + j) & (H - 1)] = np.uint32(k)
        slot_eid[(h + j) & (H - 1)] = eid
        max_probe = max(max_probe, j + 1)
    return SweepTier(keys=keys.astype(np.uint32),
                     bucket_start=bucket_start, fid=fid, anchor=anchor,
                     slot_key=slot_key, slot_eid=slot_eid,
                     max_probe=max_probe, max_bucket=max_bucket)


def _sweep_hash_size(n_keys: int) -> int:
    """Power-of-two table >= 4x the key count (<= 25% load keeps
    linear-probe clusters, and with them the probe depth, short)."""
    H = 16
    while H < 4 * n_keys:
        H *= 2
    return H


@dataclass
class SweepTier:
    """One probe tier of a SweepProgram: sorted unique probe keys with
    bucketed entry runs (factor id + window anchor per entry), the
    open-addressed hash table the device probes (slot_eid -1 = empty),
    and the static loop bounds — deepest probe cluster, deepest bucket,
    widest verify in u32 words."""

    keys: np.ndarray         # [E] u32, sorted unique
    bucket_start: np.ndarray  # [E+1] i32
    fid: np.ndarray          # [NE] i32 (min length 1)
    anchor: np.ndarray       # [NE] i32
    slot_key: np.ndarray     # [H] u32 (H a power of two)
    slot_eid: np.ndarray     # [H] i32, -1 = empty slot
    max_probe: int
    max_bucket: int
    n_words: int = 0


@dataclass
class SweepProgram:
    """Host-packed tables of the device literal sweep (built once per
    pattern set; ``ops/sweep.py`` moves them to the device).

    Two SweepTiers — ``narrow`` keyed on the factor's rarest
    little-endian 4-byte window code (3-byte factors: all 256
    extensions), ``wide`` keyed on the Fibonacci mix of the two chained
    half-window codes of its rarest 8-byte window. ``fac_len`` /
    ``fac_words`` / ``fac_wmask`` carry the factor bytes as padded u32
    words + byte masks for the exact verify, ``fac_groups`` is each
    factor's target-group bitset (32 groups per uint32 lane), and
    ``always_mask`` holds the groups owning unguarded patterns."""

    narrow: SweepTier
    wide: SweepTier
    fac_len: np.ndarray      # [F] i32 (min length 1)
    fac_words: np.ndarray    # [F, W] u32 LE factor words, zero-padded
    fac_wmask: np.ndarray    # [F, W] u32 byte masks (0 past the factor)
    fac_groups: np.ndarray   # [F, GW] u32 group bitsets
    always_mask: np.ndarray  # [GW] u32
    n_groups: int
