"""Mandatory-pair extraction: the compile side of the two-phase filter
(a copy of ``klogs_tpu/filters/compiler/prefilter.py``).

A log filter selects RARE lines, so most of the NFA kernel's work is
spent proving non-matches. This module derives, per pattern, a CNF over
adjacent byte-pair containment — an AND of OR-clauses, each clause a set
of (S1, S2) byte-set pairs such that EVERY match of the pattern contains
two adjacent bytes x in S1, y in S2 for at least one pair of the clause.
A *necessary* condition only (the classic literal-prefilter idea,
rebuilt for byte-set regexes).

The runtime test compiles each clause into one LUT bit slot: the slot's
first/second LUTs are the UNION over the clause's pairs (a slot firing
on a cross-pair over-approximates the OR — still necessary-safe), and a
pattern's requirement is the AND of its clause slots. The device side
(``ops/prefilter.py``) evaluates it over a batch; its verdict gates
which (block of lines, group) cells the gated grouped kernel scans
(``ops/nfa_kernels.py``, ``match_cls_grouped_gated``).

Extraction is structural over the parser AST (CNF per node):

- Sym(bytes B): no clauses; begins/ends with a byte in B.
- Cat: clauses of all parts plus boundary singleton clauses (last-set of
  a definite part x first-set of the next definite part, with only
  empty-only nodes between).
- Alt: CNF of an alternation distributes: (A1&A2..)|(B1&B2..) becomes
  AND over all (Ai|Bj) — clause unions, capped for size.
- Star / optional: may match empty -> true (no clauses), breaks
  adjacency.
- Sentinels (^ $): match no byte; empty-only for factor purposes.

Pairs with huge byte-sets (e.g. involving `.`) are uselessly weak and
are pruned by a selectivity cap; clauses are ranked by a byte-rarity
prior so the retained ones discriminate on real log text.
"""

from dataclasses import dataclass

import numpy as np

from klogs_tpu_torch.filters.compiler.parser import (
    Alt,
    Boundary,
    Cat,
    Epsilon,
    Star,
    Sym,
    parse,
)

# A pair side bigger than this matches too often to pay for its LUT bit.
MAX_SET_BYTES = 48
# LUT bitmask width: at most this many clause slots across the pattern
# set (W = ceil(slots/32) uint32 words per LUT entry).
MAX_PAIR_SLOTS = 512
# Keep at most this many (most selective) clauses per pattern.
MAX_CLAUSES_PER_PATTERN = 16
# Cap CNF size during Alt distribution.
MAX_CLAUSES_PER_NODE = 32
MAX_PAIRS_PER_CLAUSE = 8

Pair = tuple[frozenset, frozenset]
Clause = frozenset  # of Pair


def _byte_weight(b: int) -> float:
    """Rarity prior for ranking (smaller = rarer = more selective) on
    log-like text: punctuation/control rarest, then digits/uppercase,
    lowercase and space most common."""
    c = chr(b)
    if c.islower() or c == " ":
        return 4.0
    if c.isdigit() or c.isupper():
        return 2.0
    return 1.0


def _pair_weight(p: Pair) -> float:
    s1, s2 = p
    return (sum(_byte_weight(b) for b in s1) *
            sum(_byte_weight(b) for b in s2))


def _clause_weight(c: Clause) -> float:
    # OR of pairs: fires when any does — weakness adds up.
    return sum(_pair_weight(p) for p in c)


def _prune_clauses(clauses: set[Clause]) -> frozenset:
    """Drop clauses with oversized sets, cap counts."""
    ok = []
    for c in clauses:
        if len(c) > MAX_PAIRS_PER_CLAUSE:
            continue
        if any(len(a) > MAX_SET_BYTES or len(b) > MAX_SET_BYTES
               for a, b in c):
            continue
        ok.append(c)
    ok.sort(key=_clause_weight)
    return frozenset(ok[:MAX_CLAUSES_PER_NODE])


@dataclass(frozen=True)
class _Summary:
    """Per-node factor summary.

    kind: 'empty'   — matches ONLY the empty byte string (Epsilon,
                      sentinels): preserves adjacency, no first/last.
          'definite'— every match is a non-empty byte string whose first
                      byte is in `first` and last byte in `last`.
          'loose'   — may be empty / unknown shape: breaks adjacency.
    cnf: frozenset of clauses (each a frozenset of pairs); every matched
         string satisfies every clause.
    """

    kind: str
    first: frozenset = frozenset()
    last: frozenset = frozenset()
    cnf: frozenset = frozenset()


def _alt_cnf(cnfs: list[frozenset]) -> frozenset:
    """CNF of an alternation: fold pairwise distributions."""
    acc = cnfs[0]
    for nxt in cnfs[1:]:
        if not acc or not nxt:
            return frozenset()  # one side is 'true'
        out = {a | b for a in acc for b in nxt}
        acc = _prune_clauses(out)
    return acc


def _summarize(node: object) -> _Summary:
    if isinstance(node, (Epsilon, Boundary)):
        # \b/\B are zero-width: they preserve byte adjacency (a
        # mandatory pair across one remains mandatory) and add no
        # byte content of their own.
        return _Summary("empty")
    if isinstance(node, Sym):
        if node.sentinel is not None:
            return _Summary("empty")
        return _Summary("definite", first=node.bytes_, last=node.bytes_)
    if isinstance(node, Star):
        # Zero iterations possible: no mandatory content.
        return _Summary("loose")
    if isinstance(node, Alt):
        subs = [_summarize(p) for p in node.parts]
        cnf = _alt_cnf([s.cnf for s in subs])
        if all(s.kind == "definite" for s in subs):
            first = frozenset().union(*[s.first for s in subs])
            last = frozenset().union(*[s.last for s in subs])
            return _Summary("definite", first=first, last=last, cnf=cnf)
        if all(s.kind == "empty" for s in subs):
            return _Summary("empty", cnf=cnf)
        return _Summary("loose", cnf=cnf)
    if isinstance(node, Cat):
        subs = [_summarize(p) for p in node.parts]
        # Every part is traversed, so every part's clauses are mandatory.
        clauses: set[Clause] = set().union(*[s.cnf for s in subs]) if subs else set()
        # Boundary pairs: adjacent definite parts with only empty-only
        # parts between them become singleton clauses.
        pending_last: frozenset | None = None
        for s in subs:
            if s.kind == "definite":
                if pending_last is not None:
                    clauses.add(frozenset({(pending_last, s.first)}))
                pending_last = s.last
            elif s.kind == "loose":
                pending_last = None
            # 'empty': adjacency preserved, pending_last unchanged.
        firsts = next((s for s in subs if s.kind != "empty"), None)
        lasts = next((s for s in reversed(subs) if s.kind != "empty"), None)
        if firsts is None:  # all parts empty-only
            return _Summary("empty", cnf=_prune_clauses(clauses))
        kind = "definite" if (firsts.kind == "definite"
                              and lasts.kind == "definite") else "loose"
        return _Summary(
            kind,
            first=firsts.first if firsts.kind == "definite" else frozenset(),
            last=lasts.last if lasts.kind == "definite" else frozenset(),
            cnf=_prune_clauses(clauses),
        )
    raise TypeError(node)


def clauses_from_ast(node: object) -> "list[Clause]":
    """Mandatory pair-CNF of one PARSED pattern, most selective clause
    first — callers that already hold the AST (the regex index builds
    factors and clauses from one parse) skip the re-parse."""
    return sorted(_summarize(node).cnf, key=_clause_weight)


def mandatory_clauses(pattern: str, ignore_case: bool = False
                      ) -> list[Clause]:
    """Mandatory pair-CNF of one pattern, most selective clause first."""
    return clauses_from_ast(parse(pattern, ignore_case=ignore_case))


@dataclass
class PrefilterProgram:
    """Packed LUTs for the device candidate test.

    A line is a CANDIDATE for pattern p iff every clause slot k required
    by p fires: some adjacent (x, y) in the line has
    lut1[x,w] & lut2[y,w] bit set (slot k = word k//32, bit k%32).
    candidate(line) = OR_p AND_k. `usable` is False when some pattern
    yielded no clauses (its req mask would be all-zero =
    always-candidate, making the phase pointless)."""

    lut1: np.ndarray  # [256, W] uint32 — byte valid as a clause-pair first
    lut2: np.ndarray  # [256, W] uint32 — byte valid as a clause-pair second
    req: np.ndarray  # [P, W] uint32 — pattern p needs all these bits
    usable: bool
    # Clauses FOUND per pattern, before slot allocation (observability:
    # a zero here means the pattern truly has no mandatory pairs; a
    # nonzero count on an unusable program means the shared slot table
    # ran out — different user guidance).
    clause_counts: "list[int] | None" = None

    @property
    def n_words(self) -> int:
        return self.lut1.shape[1]


def compile_prefilter(patterns: list[str],
                      ignore_case: bool = False) -> PrefilterProgram:
    """Select up to MAX_PAIR_SLOTS clause slots across patterns and pack
    the LUTs.

    Slots are allocated GLOBALLY, not first-pattern-wins: clauses are
    deduplicated across the set and ranked by (best per-pattern rank,
    selectivity) — every pattern's rarest clause competes for a slot
    before ANY pattern's second-rarest. A pattern late in a large set
    whose best clause is shared (or rare) still gets req bits; under the
    old sequential scheme pattern #33+ of a diverse 512-clause set got
    nothing and silently disabled gating for everyone."""
    per_pattern = [mandatory_clauses(p, ignore_case) for p in patterns]
    # clause -> (best rank across patterns, weight): rank-0 clauses are
    # some pattern's most selective clause and allocate first.
    demand: dict[Clause, tuple[int, float]] = {}
    for clauses in per_pattern:
        for rank, clause in enumerate(clauses[:MAX_CLAUSES_PER_PATTERN]):
            key = (rank, _clause_weight(clause))
            prev = demand.get(clause)
            if prev is None or key < prev:
                demand[clause] = key
    order = sorted(demand, key=lambda c: demand[c])  # stable: dict order
    slot_of: dict[Clause, int] = {
        clause: i for i, clause in enumerate(order[:MAX_PAIR_SLOTS])}
    chosen: list[list[int]] = []
    usable = True
    for clauses in per_pattern:
        slots = [slot_of[c] for c in clauses
                 if c in slot_of][:MAX_CLAUSES_PER_PATTERN]
        if not slots:
            usable = False  # this pattern always passes -> no gating
        chosen.append(slots)
    W = max(1, -(-max(len(slot_of), 1) // 32))
    lut1 = np.zeros((256, W), dtype=np.uint32)
    lut2 = np.zeros((256, W), dtype=np.uint32)
    req = np.zeros((len(patterns), W), dtype=np.uint32)
    for clause, slot in slot_of.items():
        w, bit = slot // 32, np.uint32(1 << (slot % 32))
        for s1, s2 in clause:
            for b in s1:
                lut1[b, w] |= bit
            for b in s2:
                lut2[b, w] |= bit
    for i, slots in enumerate(chosen):
        for slot in slots:
            req[i, slot // 32] |= np.uint32(1 << (slot % 32))
    return PrefilterProgram(lut1=lut1, lut2=lut2, req=req, usable=usable,
                            clause_counts=[len(c) for c in per_pattern])


def candidate_matrix_host(pf: PrefilterProgram,
                          lines: list[bytes]) -> np.ndarray:
    """Reference (numpy, host) PER-PATTERN candidate matrix: [B, P]
    bool, True where the line satisfies pattern p's full clause
    requirement. The oracle for the device candidate matrix
    (ops.prefilter.candidate_matrix*) and the per-pattern narrowing
    primitive: column p False proves pattern p cannot match that line
    (necessary condition), so engines may skip it."""
    out = np.zeros((len(lines), pf.req.shape[0]), dtype=bool)
    for i, line in enumerate(lines):
        arr = np.frombuffer(line, dtype=np.uint8)
        if len(arr) < 2:
            present = np.zeros(pf.n_words, dtype=np.uint32)
        else:
            present = np.bitwise_or.reduce(
                pf.lut1[arr[:-1]] & pf.lut2[arr[1:]], axis=0)
        out[i] = ((present[None, :] & pf.req) == pf.req).all(axis=1)
    return out


def candidates_host(pf: PrefilterProgram, lines: list[bytes]) -> list[bool]:
    """Reference (numpy, host) any-pattern candidate test — the oracle
    for the device implementation and a quick selectivity probe."""
    return candidate_matrix_host(pf, lines).any(axis=1).tolist()
