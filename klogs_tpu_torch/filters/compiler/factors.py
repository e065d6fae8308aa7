"""Mandatory literal-factor extraction: the multi-byte half of the
regex index (a copy of ``klogs_tpu/filters/compiler/factors.py``).

The pair-CNF prefilter (prefilter.py) answers "which adjacent byte
pairs must appear"; this module answers the stronger question "which
multi-byte LITERALS must appear" — the classic literal-index idea from
"Regular Expression Indexing for Log Analysis" (PAPERS.md) and
Hyperscan's literal decomposition. A factor of ``panic:`` is worth far
more than its five constituent pairs: pairs may be scattered anywhere
in a line, a factor must occur contiguously, so a q-gram sweep over it
narrows thousands of patterns to a handful of candidates per line
(filters/compiler/index.py builds that sweep).

Extraction is structural over the parser AST. Every node summarizes to
(exact, pref, suff, factors):

- ``exact``  — the node's byte language is exactly {exact} (literals,
  and zero-width nodes as the empty string: sentinels and \\b consume
  no line bytes, so they are transparent to containment-necessity).
- ``pref``/``suff`` — mandatory literal prefix/suffix of every match.
- ``factors`` — internal literals every match must contain.

Cat concatenates prefix/suffix chains and mints the boundary literal
``a.suff + b.pref`` (contiguous by construction). Alt keeps only what
is mandatory in EVERY branch: the longest common prefix/suffix, plus
maximal common substrings of the branches' mandatory sets (a substring
of a mandatory literal is itself mandatory). Star and other nullable
or shape-unknown content contribute nothing — exactly the
conservatism that keeps the index a NECESSARY condition: a reported
factor absent from a line proves the pattern cannot match it, never
the reverse.
"""

from dataclasses import dataclass

from klogs_tpu_torch.filters.compiler.parser import (
    Alt,
    Boundary,
    Cat,
    Epsilon,
    Star,
    Sym,
    parse,
)

# THE rarity prior (shared with clause selectivity ranking — one
# source of truth: tuning it re-ranks clauses, factor scores, and the
# sweep's window anchoring together).
from klogs_tpu_torch.filters.compiler.prefilter import _byte_weight as _byte_rarity

# Factors shorter than this carry too little selectivity to index
# (the q-gram sweep needs >= 4 bytes; 3-byte factors still help the
# host verify step).
MIN_FACTOR_LEN = 3
# Stored-literal cap: prefixes/suffixes truncate to their outer
# MAX_FACTOR_LEN bytes (a truncation of a mandatory literal is itself
# mandatory), bounding work on pathological literal walls.
MAX_FACTOR_LEN = 24
# An exact literal longer than this demotes to pref/suff form.
_EXACT_CAP = 64
MAX_FACTORS_PER_PATTERN = 4


@dataclass(frozen=True)
class _FSum:
    """Factor summary of one AST node (see module docstring)."""

    exact: "bytes | None"
    pref: bytes = b""
    suff: bytes = b""
    factors: frozenset = frozenset()


_EMPTY = _FSum(exact=b"")
_UNKNOWN = _FSum(exact=None)


def factor_score(f: bytes) -> float:
    """Ranking key: smaller = more selective. Length dominates (every
    extra byte multiplies selectivity), rarity breaks ties."""
    rarity = sum(_byte_rarity(b) for b in f) / max(1, len(f))
    return -float(len(f)) * 8.0 + rarity


def _trunc_pref(s: bytes) -> bytes:
    return s[:MAX_FACTOR_LEN]


def _trunc_suff(s: bytes) -> bytes:
    return s[-MAX_FACTOR_LEN:] if len(s) > MAX_FACTOR_LEN else s


def _demote(s: _FSum) -> _FSum:
    """Exact literal grown past the cap -> pref/suff form."""
    if s.exact is None or len(s.exact) <= _EXACT_CAP:
        return s
    return _FSum(exact=None, pref=_trunc_pref(s.exact),
                 suff=_trunc_suff(s.exact),
                 factors=frozenset({s.exact[:MAX_FACTOR_LEN]}))


def _cat2(a: _FSum, b: _FSum) -> _FSum:
    if a.exact is not None and b.exact is not None:
        return _demote(_FSum(exact=a.exact + b.exact))
    a_suff = a.exact if a.exact is not None else a.suff
    b_pref = b.exact if b.exact is not None else b.pref
    pref = _trunc_pref(a.exact + b.pref) if a.exact is not None else a.pref
    suff = _trunc_suff(a.suff + b.exact) if b.exact is not None else b.suff
    factors = set(a.factors) | set(b.factors)
    mid = _trunc_suff(a_suff) + _trunc_pref(b_pref)
    if mid:
        factors.add(_trunc_pref(mid) if len(mid) > MAX_FACTOR_LEN else mid)
    return _FSum(exact=None, pref=pref, suff=suff,
                 factors=frozenset(factors))


def _mandatory_set(s: _FSum) -> frozenset:
    """Every literal the summary proves mandatory (empties dropped)."""
    out = set(s.factors)
    if s.exact is not None:
        out.add(s.exact)
    else:
        out.add(s.pref)
        out.add(s.suff)
    out.discard(b"")
    return frozenset(out)


def _common_pref(items: "list[bytes]") -> bytes:
    out = items[0]
    for s in items[1:]:
        n = 0
        for x, y in zip(out, s):
            if x != y:
                break
            n += 1
        out = out[:n]
    return out


def _alt(subs: "list[_FSum]") -> _FSum:
    exacts = [s.exact for s in subs]
    if all(e is not None and e == exacts[0] for e in exacts):
        return subs[0]
    prefs = [s.exact if s.exact is not None else s.pref for s in subs]
    suffs = [s.exact if s.exact is not None else s.suff for s in subs]
    pref = _common_pref(prefs)
    suff = _common_pref([s[::-1] for s in suffs])[::-1]
    # Common substrings: s is mandatory for the Alt iff every branch
    # has a mandatory literal containing s. Enumerate branch-0 substrings
    # (bounded: literals are <= MAX_FACTOR_LEN), keep the maximal ones.
    sets = [_mandatory_set(s) for s in subs]
    common: set[bytes] = set()
    if all(sets):
        cands: set[bytes] = set()
        for f in sets[0]:
            for i in range(len(f)):
                for j in range(i + MIN_FACTOR_LEN, len(f) + 1):
                    cands.add(f[i:j])
        for c in cands:
            if all(any(c in f for f in fs) for fs in sets[1:]):
                common.add(c)
        common = {c for c in common
                  if not any(c != d and c in d for d in common)}
    return _FSum(exact=None, pref=pref, suff=suff,
                 factors=frozenset(common))


def _summarize(node: object) -> _FSum:
    if isinstance(node, (Epsilon, Boundary)):
        return _EMPTY
    if isinstance(node, Sym):
        if node.sentinel is not None:
            return _EMPTY  # zero line bytes: transparent
        if len(node.bytes_) == 1:
            return _FSum(exact=bytes([next(iter(node.bytes_))]))
        return _UNKNOWN
    if isinstance(node, Star):
        return _FSum(exact=None)  # zero iterations: nothing mandatory
    if isinstance(node, Cat):
        acc = _EMPTY
        for part in node.parts:
            acc = _cat2(acc, _summarize(part))
        return acc
    if isinstance(node, Alt):
        return _alt([_summarize(p) for p in node.parts])
    raise TypeError(node)


def factors_from_ast(node: object) -> "list[bytes]":
    """Mandatory literal factors of a parsed pattern, most selective
    first, capped at MAX_FACTORS_PER_PATTERN, each >= MIN_FACTOR_LEN.
    Overlapping/substring-redundant entries are pruned."""
    s = _summarize(node)
    cands = sorted((f for f in _mandatory_set(s)
                    if len(f) >= MIN_FACTOR_LEN), key=factor_score)
    out: "list[bytes]" = []
    for f in cands:
        if any(f in kept for kept in out):
            continue  # substring of a stronger kept factor: redundant
        out.append(f)
        if len(out) >= MAX_FACTORS_PER_PATTERN:
            break
    return out


# An OR-guard wider than this matches too many lines to pay for its
# sweep entries; the pattern stays unindexed (always-candidate).
MAX_GUARD_FACTORS = 8

# Bounded class enumeration: a run of small byte classes has a small
# finite language ("5[12]\d " is 20 four-byte literals), and that
# language is an OR-guard — every match contains exactly one member.
# Without it, any class inside the literal chain breaks extraction and
# the pattern degrades to always-candidate even when its language is
# nearly literal. Enumerated guards may exceed MAX_GUARD_FACTORS (that
# cap prices human-written alternations, whose branches are broad);
# enumerated members are same-length siblings differing in one class
# byte, so the family is as rare as its rarest member times the class
# size — priced by _ENUM_GUARD_MAX instead.
_ENUM_SET_MAX = 16    # widest byte class worth enumerating
_ENUM_GUARD_MAX = 32  # total literals per enumerated family
_ENUM_MIN_LEN = 4     # one full narrow probe window (index.NARROW)


def _enum_lits(node: object) -> "list[bytes] | None":
    """The node's full byte language when finite and small, else None.
    Zero-width nodes contribute the empty string (transparent)."""
    if isinstance(node, (Epsilon, Boundary)):
        return [b""]
    if isinstance(node, Sym):
        if node.sentinel is not None:
            return [b""]
        if len(node.bytes_) > _ENUM_SET_MAX:
            return None
        return [bytes([b]) for b in sorted(node.bytes_)]
    if isinstance(node, Cat):
        acc = [b""]
        for part in node.parts:
            sub = _enum_lits(part)
            if sub is None:
                return None
            acc = [a + s for a in acc for s in sub]
            if len(acc) > _ENUM_GUARD_MAX:
                return None
        return acc
    if isinstance(node, Alt):
        out: "list[bytes]" = []
        for part in node.parts:
            sub = _enum_lits(part)
            if sub is None:
                return None
            out.extend(sub)
            if len(out) > _ENUM_GUARD_MAX:
                return None
        return out
    return None  # Star / unknown: unbounded or nullable


def _enum_guard(parts: "list[object]", banned: "object | None"
                ) -> "list[bytes] | None":
    """Best enumerated OR-guard over contiguous runs of enumerable
    parts. A match of the Cat contains a match of parts[i:j]
    consecutively, hence contains one member of that run's (finite)
    language — so each run's literal set is a valid OR-guard; the
    best-scored one wins."""
    best: "list[bytes] | None" = None
    best_score = 0.0
    for i in range(len(parts)):
        lits = [b""]
        for part in parts[i:]:
            sub = _enum_lits(part)
            if sub is None:
                break
            nxt = [a + s for a in lits for s in sub]
            if len(nxt) > _ENUM_GUARD_MAX:
                break
            lits = nxt
            fam = [_trunc_pref(f) for f in lits]
            if (any(len(f) < _ENUM_MIN_LEN for f in fam)
                    or len(set(fam)) != len(fam)
                    or (banned is not None and any(banned(f)
                                                   for f in fam))):
                continue
            score = max(factor_score(f) for f in fam)
            if best is None or score < best_score:
                best, best_score = fam, score
    return best


def guard_factors(node: object,
                  banned: "object | None" = None
                  ) -> "list[bytes] | None":
    """OR-semantics guard for the regex index: a set of literals such
    that EVERY match of the pattern contains AT LEAST ONE of them.

    A pattern with a mandatory factor guards on its rarest one
    (singleton OR-set). A pattern that is an alternation with no
    common factor — ``FATAL|CRIT`` — still guards: every match matches
    some branch, so the union of per-branch guards is necessary. A
    concatenation whose own factor chain yields nothing usable still
    guards through any one guardable PART — a match of the Cat
    contains a match of every part, so a part's guard is necessary for
    the whole; the best-scored part guard wins.
    Returns None when no guard exists (nullable content everywhere, or
    an alternation with an unguardable branch): the pattern must stay
    an always-candidate.

    ``banned`` (optional predicate ``bytes -> bool``) vetoes guard
    literals the caller has measured to be useless on the live corpus
    — a factor present in ~every line narrows nothing while taxing
    every sweep position (the IndexedFilter's adaptive re-guard;
    docs/PATTERNS.md). Banning only restricts the CHOICE of guard:
    whatever survives is still a necessary condition, and a pattern
    with no unbanned guard degrades to always-candidate — necessity is
    preserved under any ban."""
    fs = [f for f in factors_from_ast(node)
          if banned is None or not banned(f)]
    if fs:
        return [fs[0]]
    if isinstance(node, Alt):
        out: "list[bytes]" = []
        for part in node.parts:
            sub = guard_factors(part, banned)
            if sub is None:
                return None
            for f in sub:
                if f not in out:
                    out.append(f)
            if len(out) > MAX_GUARD_FACTORS:
                return None
        return out
    if isinstance(node, Cat):
        best: "list[bytes] | None" = None
        best_score = 0.0
        for part in node.parts:
            sub = guard_factors(part, banned)
            if sub is None:
                continue
            # An OR-set is as selective as its WORST member.
            score = max(factor_score(f) for f in sub)
            if best is None or score < best_score:
                best, best_score = sub, score
        enum = _enum_guard(list(node.parts), banned)
        if enum is not None:
            score = max(factor_score(f) for f in enum)
            if best is None or score < best_score:
                best = enum
        return best
    return None


def mandatory_factors(pattern: str, ignore_case: bool = False
                      ) -> "list[bytes]":
    """Parse + extract. Case-insensitive patterns casefold their byte
    sets in the parser, so cased letters become 2-byte sets and drop
    out of the literal chain — such patterns simply yield fewer (often
    zero) factors and lean on the pair-CNF index instead."""
    return factors_from_ast(parse(pattern, ignore_case=ignore_case))
