"""Pattern grouping for thousand-pattern mode (a copy of
``klogs_tpu/filters/compiler/groups.py``).

One automaton over K patterns stops scaling long before K reaches
production alerting-set sizes: subset construction over a union NFA
blows up combinatorially (the 32-pattern north-star set already
determinizes to ~8.5k states), and the grouped kernel's cost grows
with total positions. The fix — per "Regular Expression Indexing
for Log Analysis" (PAPERS.md) and Hyperscan's bucketed literal engines
— is to partition the set into bounded GROUPS, compile one table per
group, and let the factor index (index.py) narrow each line to its
candidate groups so engines scan a handful of groups, not K patterns.

Grouping heuristics (plan_groups):

- **Factor overlap:** guarded patterns are ordered by their primary
  guard literal, so patterns sharing factors land in the same group —
  one present factor lights up one group, not a smear across many.
  Shared byte structure also keeps the per-group byte classifier (and
  hence DFA alphabet) small: byte-classifier compatibility falls out
  of literal adjacency.
- **Bounded compile:** groups cap both member count and total Glushkov
  positions, so per-group subset construction stays small and
  rebuildable; a group that still overflows its DFA state budget
  degrades to a combined-`re` scan of just that group (engine side).
- **Segregated residuals:** patterns with no guard (nullable shapes,
  case-folded literals) make their whole group an always-candidate —
  grouping them together confines the damage instead of poisoning
  groups of well-guarded patterns. Patterns outside the compiler's
  RE2 subset group separately again (their group can never compile a
  DFA and goes straight to `re`).
"""

from dataclasses import dataclass, field

import numpy as np

from klogs_tpu_torch.filters.compiler.factors import factors_from_ast, guard_factors
from klogs_tpu_torch.filters.compiler.parser import RegexSyntaxError, parse
from klogs_tpu_torch.filters.compiler.prefilter import clauses_from_ast

# Group budgets: member cap matches the north-star set size (a group is
# "one yesterday's-whole-pattern-set worth" of work); the position cap
# keeps per-group subset construction comfortably inside the DFA state
# budget for log-like patterns.
MAX_GROUP_PATTERNS = 32
MAX_GROUP_POSITIONS = 384


@dataclass(frozen=True)
class PatternInfo:
    """Per-pattern index analysis (one parse feeds everything).

    guard: OR-set of literals — every match contains at least one — or
           None when the pattern cannot be guarded (always-candidate).
    positions: Glushkov position count, None when the pattern is
           outside the compiler subset (no DFA or device table possible).
    factors / clauses: extraction counts for observability.
    """

    index: int
    pattern: str
    guard: "tuple[bytes, ...] | None"
    positions: "int | None"
    factors: int
    clauses: int


def analyze(patterns: "list[str]", ignore_case: bool = False,
            banned: "object | None" = None) -> "list[PatternInfo]":
    """Parse each pattern once; extract guard factors, pair-CNF clause
    count, and automaton size. Patterns the compiler cannot parse get
    (guard=None, positions=None) and ride the `re` fallback path.
    ``banned`` (a ``bytes -> bool`` predicate) vetoes guard literals —
    see factors.guard_factors; necessity holds under any ban."""
    from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns

    out: "list[PatternInfo]" = []
    for i, pat in enumerate(patterns):
        try:
            ast = parse(pat, ignore_case=ignore_case)
        except (RegexSyntaxError, ValueError):
            out.append(PatternInfo(i, pat, None, None, 0, 0))
            continue
        guard = guard_factors(ast, banned)
        n_factors = len(factors_from_ast(ast))
        n_clauses = len(clauses_from_ast(ast))
        try:
            positions: "int | None" = compile_patterns(
                [pat], ignore_case=ignore_case).n_states
        except (RegexSyntaxError, ValueError):
            positions = None
        out.append(PatternInfo(
            i, pat, tuple(guard) if guard is not None else None,
            positions, n_factors, n_clauses))
    return out


def reguard_infos(infos: "list[PatternInfo]", ignore_case: bool = False,
                  banned: "object | None" = None) -> "list[PatternInfo]":
    """Re-run ONLY guard extraction over already-analyzed patterns
    (the IndexedFilter's adaptive re-guard): positions / factor /
    clause counts are invariant under a ban, so the expensive
    per-pattern automaton sizing from ``analyze`` is reused and the
    rebuild costs one parse per pattern. The group plan stays valid —
    it partitions pattern INDICES — but a pattern whose guard vanishes
    under the ban must make its group always-candidate; FactorIndex
    derives that from the infos themselves."""
    out: "list[PatternInfo]" = []
    for info in infos:
        if info.guard is None and info.positions is None:
            out.append(info)  # unparseable: nothing to re-extract
            continue
        try:
            ast = parse(info.pattern, ignore_case=ignore_case)
        except (RegexSyntaxError, ValueError):
            out.append(info)
            continue
        guard = guard_factors(ast, banned)
        out.append(PatternInfo(
            info.index, info.pattern,
            tuple(guard) if guard is not None else None,
            info.positions, info.factors, info.clauses))
    return out


@dataclass
class GroupPlan:
    """Partition of the pattern set into compile groups.

    groups: pattern indices per group (original order within a group).
    group_of: [P] int32, pattern index -> group id.
    always_groups: group ids holding at least one unguarded pattern —
        the index must treat these as candidates for every line.
    """

    groups: "list[list[int]]" = field(default_factory=list)
    group_of: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    always_groups: "tuple[int, ...]" = ()

    @property
    def n_groups(self) -> int:
        return len(self.groups)


def plan_groups(infos: "list[PatternInfo]",
                max_group_patterns: int = MAX_GROUP_PATTERNS,
                max_group_positions: int = MAX_GROUP_POSITIONS
                ) -> GroupPlan:
    """Partition analyzed patterns into bounded, factor-clustered
    groups (see module docstring for the heuristics)."""
    guarded = [i for i in infos if i.guard is not None
               and i.positions is not None]
    bare = [i for i in infos if i.guard is None and i.positions is not None]
    alien = [i for i in infos if i.positions is None]
    # Factor-overlap clustering: contiguous packing over the
    # primary-guard sort order, NOT first-fit across the whole set —
    # adjacency in the sort IS the overlap signal.
    guarded.sort(key=lambda i: (i.guard[0], i.index))

    groups: "list[list[int]]" = []

    def pack(bucket: "list[PatternInfo]") -> None:
        cur: "list[int]" = []
        load = 0
        for info in bucket:
            pos = info.positions or 1
            if cur and (len(cur) >= max_group_patterns
                        or load + pos > max_group_positions):
                groups.append(cur)
                cur, load = [], 0
            cur.append(info.index)
            load += pos
        if cur:
            groups.append(cur)

    pack(guarded)
    n_guarded_groups = len(groups)
    pack(bare)  # parseable but unguardable: always-candidate groups
    pack(alien)  # outside the compiler subset: always-candidate + `re`

    group_of = np.zeros(len(infos), dtype=np.int32)
    for g, members in enumerate(groups):
        for p in members:
            group_of[p] = g
    always = tuple(range(n_guarded_groups, len(groups)))
    return GroupPlan(groups=groups, group_of=group_of,
                     always_groups=always)
