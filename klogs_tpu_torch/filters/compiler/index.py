"""The multi-literal index, packed for the device literal sweep.

A copy of the part of ``klogs_tpu/filters/compiler/index.py`` that the
device path needs. Every guarded pattern contributes an OR-set of
mandatory literals (factors.guard_factors); the index dedupes them
across the set, decides once per factor which probe tier and which
window of it the sweep keys on, and packs the result into the
``SweepProgram`` tables that ``ops/sweep.py`` evaluates on the device.
A line is a candidate for group g iff some member pattern's guard
literal occurs inside it (or g is an always-candidate group); every
guard is a NECESSARY condition, so the gate never hides a match.

Left out, because only the host engines use them (``--backend cpu``,
the indexed engine; still to port): the native blob, the MultiDFA
program blob and their knobs, the stage-1 blooms, and the host sweep
itself (``_hits``/``_emit``, ``group_candidates``, the ``native_*``
methods). The device sweep needs none of them: its dense exact hash
probe is the gate.

Probe design (shared with the host sweep, so the two give the same
mask): factors of 8 bytes or more key the WIDE tier on two chained
4-byte codes of their rarest 8-byte window; shorter ones key the
NARROW tier on their rarest 4-byte window; 3-byte factors enter the
narrow tier as all 256 one-byte extensions (the 4th byte is verified
as don't-care). Windows sit at the factor's rarest position by a
static log-text prior, or by observed code counts when ``code_freq``
is given.
"""

from dataclasses import dataclass

import numpy as np

from klogs_tpu_torch.filters.compiler.factors import MAX_FACTOR_LEN as SWEEP_FACTOR_CAP
from klogs_tpu_torch.filters.compiler.factors import _byte_rarity
from klogs_tpu_torch.filters.compiler.groups import GroupPlan, PatternInfo

# Minimum factor width the sweep can probe: matches
# factors.MIN_FACTOR_LEN (every guard literal is at least 3 bytes).
GRAM = 3
# Probe window widths: the wide tier (two chained 4-byte codes) for
# factors that fit one, the narrow tier (one code) for the rest.
WIDE = 8
NARROW = 4
_FIB = 2654435761
_LITTLE = np.little_endian

# Static rarity prior on log-like text for window anchoring, from the
# one scoring table (factors._byte_rarity: smaller = rarer), negated so
# that _anchor's argmax picks the rarest window.
_BYTE_RARITY = np.asarray([-_byte_rarity(b) for b in range(256)],
                          dtype=np.float64)


def _anchor(f: bytes, width: int) -> int:
    """Offset of the rarest ``width``-byte window of ``f``."""
    w = _BYTE_RARITY[np.frombuffer(f, dtype=np.uint8)]
    if len(f) <= width:
        return 0
    sums = np.convolve(w, np.ones(width), mode="valid")
    return int(np.argmax(sums))


def sweep_factor(f: bytes) -> bytes:
    """The exact bytes the sweep indexes for guard literal ``f``:
    over-long literals (past SWEEP_FACTOR_CAP) are cut to their rarest
    cap-width window — a substring of a mandatory literal is itself
    mandatory."""
    if len(f) > SWEEP_FACTOR_CAP:
        at = _anchor(f, SWEEP_FACTOR_CAP)
        return f[at:at + SWEEP_FACTOR_CAP]
    return f


def _fold1(code: int) -> int:
    """16-bit Fibonacci fold of one 4-byte code (the host sweep's bloom
    index; kept for parity with the reference index)."""
    return ((code * _FIB) & 0xFFFFFFFF) >> 16


def _code_at(f: bytes, at: int) -> int:
    """The 4-byte code of factor ``f`` at offset ``at``, in native byte
    order (the order the observed ``code_freq`` counts are keyed in)."""
    return int.from_bytes(f[at:at + 4].ljust(4, b"\0"),
                          "little" if _LITTLE else "big")


class FactorIndex:
    """The factor tables of one analyzed, grouped pattern set: factor
    dedupe, always-candidate groups, and each factor's probe tier and
    window anchor, from which ``sweep_program`` packs the device tables.

    ``code_freq`` (optional, {native-endian 4-byte code: observed
    count}) re-anchors probe windows on observed density first and the
    static prior second; a >= WIDE factor whose best 4-byte window is
    rarer than its best 8-byte window's head demotes to the narrow
    tier. Anchoring only moves the window within the factor, so
    necessity is untouched."""

    def __init__(self, infos: "list[PatternInfo]", plan: GroupPlan,
                 code_freq: "dict[int, int] | None" = None) -> None:
        self._code_freq = code_freq or {}
        self.n_patterns = len(infos)
        self.n_groups = plan.n_groups
        # Always-candidate groups: the plan's, plus any group holding a
        # pattern whose info carries no guard.
        always = set(int(g) for g in plan.always_groups)
        for info in infos:
            if info.guard is None:
                always.add(int(plan.group_of[info.index]))
        self.always_groups = np.asarray(sorted(always), dtype=np.int64)
        # Dedupe guard literals across the set (over-long ones as their
        # rarest SWEEP_FACTOR_CAP window); per literal, the patterns it
        # guards and the groups those patterns live in.
        by_factor: "dict[bytes, list[int]]" = {}
        for info in infos:
            for f in info.guard or ():
                by_factor.setdefault(sweep_factor(f),
                                     []).append(info.index)
        self.factors: "list[bytes]" = sorted(by_factor)
        self.pattern_ids: "list[np.ndarray]" = [
            np.asarray(by_factor[f], dtype=np.int64) for f in self.factors]
        self.group_ids: "list[np.ndarray]" = [
            np.unique(plan.group_of[pids]).astype(np.int64)
            for pids in self.pattern_ids]
        # Guarded = appears in some factor's pattern set; the
        # complement makes its group an always-candidate.
        self.guarded = np.zeros(self.n_patterns, dtype=bool)
        for pids in self.pattern_ids:
            self.guarded[pids] = True
        self._group_of = np.asarray(plan.group_of, dtype=np.int32)
        self._sweep_prog: "SweepProgram | None" = None
        # The per-factor probe decision (tier, window anchor), made once.
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

    @property
    def n_factors(self) -> int:
        return len(self.factors)

    def _anchor_of(self, f: bytes, width: int) -> int:
        """Probe-window offset for factor ``f``: observed density first
        (class docstring), static rarity prior as the tie-break — or
        the prior alone when no observations exist."""
        if not self._code_freq or len(f) <= width:
            return _anchor(f, width)
        w = _BYTE_RARITY[np.frombuffer(f, dtype=np.uint8)]
        sums = np.convolve(w, np.ones(width), mode="valid")
        best = 0
        best_key: "tuple[int, float] | None" = None
        for o in range(len(f) - width + 1):
            key = (self._code_freq.get(_code_at(f, o), 0),
                   -float(sums[o]))
            if best_key is None or key < best_key:
                best_key, best = key, o
        return best

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
