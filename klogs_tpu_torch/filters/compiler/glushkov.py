"""Glushkov position automaton → dense arrays for the GPU engine.

A copy of ``klogs_tpu.filters.compiler.glushkov`` (the port imports
nothing of the JAX package). Why Glushkov (and not Thompson/DFA): the
position automaton has no epsilon transitions and the *defining*
property that every state is entered only on its own symbol class. The
whole per-character update therefore factors into a
character-independent reachability step and a character-dependent
mask:

    v' = (reachable-from(v) | inject) & B[class(c)]

On the GPU a line's state set is a bitset, ``reachable-from`` is the OR
of the follow rows of its set bits, and ``B[class(c)]`` one table row
(ops/csrc/nfa_kernels.cu). A DFA would need data-dependent table walks
over an exponential state space; Thompson NFAs need epsilon closure.

Anchors arrive from the parser as BEGIN/END sentinel symbols; the
engine feeds a virtual BEGIN before byte 0 and END after the last
byte, so ^/$ need no special-casing here and nullability of the
symbol-regex is exactly "matches every line" (match_all).

Word-boundary assertions (\\b/\\B) also compile to static structure,
with zero runtime cost: every pair of consecutively consumed symbols
has one adjacency relation (word-categories equal / differ / the
BEGIN→END empty-line pair), an assertion is a constraint on the
relation, and constraints intersect through sequencing and union
through alternation. Mid-pattern assertions filter follow edges (over
category-pure, pre-split positions); leading ones route injection
through always-injected context positions that track the previous
symbol's category; trailing ones route acceptance through
boundary-check positions that consume the next symbol. See
compile_patterns for the wiring and the interpreter-probed empty-line
rule.

Byte-class compression: bytes with identical membership across all
position symbol-sets collapse to one class, so the character-mask
table is [n_classes, S] with n_classes typically ≪ 256.
"""

from dataclasses import dataclass

import numpy as np

from klogs_tpu_torch.filters.compiler.parser import (
    BEGIN,
    END,
    _ALL_BYTES,
    _CLASS_W,
    Alt,
    Boundary,
    Cat,
    Epsilon,
    RegexSyntaxError,
    Star,
    Sym,
    max_positions_cap,
    parse,
)

# The union-automaton position cap equals the parser's per-pattern cap
# (parser.MAX_POSITIONS, overridden by the same
# KLOGS_MAX_PATTERN_POSITIONS knob, read once per _Builder) so raising
# or tightening one cap never leaves the other silently binding.


@dataclass
class NFAProgram:
    """Dense automaton arrays, ready to pad + ship to the engine.

    Class-id layout: 0..n_byte_classes-1 are byte classes (byte_class
    maps each of the 256 byte values to one), then begin_class,
    end_class, pad_class. pad_class has an all-zero row in char_mask so
    padded tail positions kill all states while sticky `matched` holds.
    """

    n_states: int
    n_classes: int
    byte_class: np.ndarray  # [256] int32
    begin_class: int
    end_class: int
    pad_class: int
    char_mask: np.ndarray  # [n_classes, n_states] bool — B table
    follow: np.ndarray  # [n_states, n_states] bool — F[i,j]: j in follow(i)
    inject: np.ndarray  # [n_states] bool — firstpos(root), injected each step
    accept: np.ndarray  # [n_states] bool — lastpos(root)
    match_all: bool  # symbol-regex nullable → empty match everywhere
    patterns: tuple  # the source pattern strings, for repr/debug


# Adjacency-relation bitmask (word-boundary assertions): every pair of
# consecutively consumed symbols has exactly one relation, and a
# constraint is the set of relations it admits. Sentinels count as
# non-word (re's edge-of-string rule) — EXCEPT the BEGIN→END adjacency
# (the empty line), which gets its own relation because re 3.12 lets
# neither \b nor \B match the empty string while unconstrained empty
# matches (Epsilon) of course do. Constraints compose by intersection
# (sequencing) and union (alternation); no special cases.
_EQ = 1  # categories equal          (what \B demands)
_NEQ = 2  # categories differ        (what \b demands)
_EMPTY = 4  # the BEGIN→END adjacency (the empty line)
_FULL = 7  # unconstrained

# Whether the assertions admit the empty-line adjacency is
# INTERPRETER-dependent: Python 3.12 made re.search(rb"\B", b"") not
# match (and 3.14 reverts it, gh-124130). The running `re` is both the
# property-test oracle and the production CPU baseline, so probe it
# once and encode whatever it does — the compiled engine then agrees
# with it on every interpreter version.
import re as _re

_B_NULLS = _NEQ | (_EMPTY if _re.search(rb"\b", b"") else 0)
_NB_NULLS = _EQ | (_EMPTY if _re.search(rb"\B", b"") else 0)


class _Builder:
    def __init__(self) -> None:
        self.symbols: list[object] = []  # per position: frozenset | BEGIN | END
        self.follow: list[set[int]] = []
        self.max_union = max_positions_cap()  # read once per build
        # Structural anchor-after-anchor adjacencies (divergent vs re's
        # idempotent assertions) — recorded even when a boundary
        # constraint would drop the edge, because re still matches e.g.
        # ``^\b^`` on a word-initial line while the sentinel stream
        # cannot provide BEGIN twice.
        self.divergent: list[int] = []  # position i of the earlier anchor

    def new_pos(self, symbol: object) -> int:
        if len(self.symbols) >= self.max_union:
            raise RegexSyntaxError(
                f"pattern set too large: more than "
                f"{self.max_union} total positions "
                "(KLOGS_MAX_PATTERN_POSITIONS overrides the cap)"
            )
        self.symbols.append(symbol)
        self.follow.append(set())
        return len(self.symbols) - 1

    def cat(self, i: int) -> int:
        """Word-category of position i's symbol: 1 word, 0 non-word.
        Only consulted on constrained edges, whose endpoints are
        category-pure by the _split_mixed_syms pre-pass."""
        s = self.symbols[i]
        if s is BEGIN or s is END:
            return 0
        if s <= _CLASS_W:
            return 1
        if not (s & _CLASS_W):
            return 0
        raise AssertionError(
            "mixed word/non-word position on a boundary-constrained "
            "edge — _split_mixed_syms must run on boundary patterns")

    def edge(self, i: int, j: int, cons: int) -> None:
        """Add follow edge i→j if the adjacency constraint admits the
        two symbols' categories."""
        si, sj = self.symbols[i], self.symbols[j]
        if (si is BEGIN or si is END) and (
                sj is BEGIN or (si is END and sj is END)):
            # Anchor directly (or across zero-width/optional content)
            # after another anchor: re's idempotent assertions diverge
            # from one-sentinel-per-line symbols (^^, $$, $^, ^\b^).
            # An ordinary symbol before BEGIN (a^b) stays materialized:
            # BEGIN's class never recurs, so it matches nothing, which
            # is re's behavior too.
            self.divergent.append(i)
            return
        if cons == _FULL:
            self.follow[i].add(j)
            return
        if not cons:
            return
        if si is BEGIN and sj is END:
            rel = _EMPTY  # the empty line: ^$ keeps it, ^\b?$ etc. do not
        else:
            rel = _EQ if self.cat(i) == self.cat(j) else _NEQ
        if rel & cons:
            self.follow[i].add(j)

    def visit(self, node: object) -> tuple[int, list, list]:
        """Returns (nulls, first, last).

        ``nulls``: _EQ|_NEQ|_EMPTY bits — the set of adjacency
        relations under which the node matches empty (_FULL for an
        unconditional empty match).
        ``first``/``last``: lists of (position, entry/exit constraint
        bits) — the constraint an edge into/out of the subexpression
        must satisfy (from boundary assertions at its rim). Fresh
        positions are allocated per *visit*, so subtrees shared by
        counted-repeat expansion linearize correctly."""
        if isinstance(node, Epsilon):
            return _FULL, [], []
        if isinstance(node, Boundary):
            return _NB_NULLS if node.negate else _B_NULLS, [], []
        if isinstance(node, Sym):
            p = self.new_pos(node.sentinel if node.sentinel else node.bytes_)
            return 0, [(p, _FULL)], [(p, _FULL)]
        if isinstance(node, Star):
            _, first, last = self.visit(node.inner)
            for i, ti in last:
                for j, tj in first:
                    self.edge(i, j, ti & tj)
            # Zero iterations: unconditional empty. (Assertion-only
            # iterations never ADD matches — skipping them is always
            # at least as permissive.)
            return _FULL, first, last
        if isinstance(node, Alt):
            nulls, first, last = 0, [], []
            for part in node.parts:
                n, f, la = self.visit(part)
                nulls |= n
                first += f
                last += la
            return nulls, first, last
        if isinstance(node, Cat):
            nulls, first, last = _FULL, [], []
            for part in node.parts:
                n, f, la = self.visit(part)
                for i, ti in last:
                    for j, tj in f:
                        self.edge(i, j, ti & tj)
                if nulls:  # prefix nullable: its bits constrain entry
                    first += [(j, tj & nulls) for j, tj in f if tj & nulls]
                if n:  # part nullable: its bits constrain earlier exits
                    last = la + [(i, ti & n) for i, ti in last if ti & n]
                else:
                    last = la
                # Empty match of the whole Cat: both sides empty on the
                # SAME adjacency — intersect.
                nulls &= n
            return nulls, first, last
        raise TypeError(f"unknown AST node {node!r}")


_DIVERGENT_ANCHOR_MSG = (
    "consecutive anchors (with only optional or zero-width content "
    "between) in {pat!r} are not supported: the engine consumes one "
    "BEGIN/END sentinel per line, so re's idempotent-assertion "
    "semantics cannot be honored"
)


def _contains_boundary(node: object) -> bool:
    if isinstance(node, Boundary):
        return True
    if isinstance(node, (Cat, Alt)):
        return any(_contains_boundary(p) for p in node.parts)
    if isinstance(node, Star):
        return _contains_boundary(node.inner)
    return False


def _split_mixed_syms(node: object) -> object:
    """Rewrite Syms whose byte set mixes word and non-word bytes into an
    Alt of the two pure halves, so every position has a definite
    word-category for boundary-edge filtering. Run only on patterns
    that contain \\b/\\B (costs up to 2x positions)."""
    if isinstance(node, Sym):
        if node.sentinel is not None:
            return node
        w = node.bytes_ & _CLASS_W
        nw = node.bytes_ - _CLASS_W
        if w and nw:
            return Alt((Sym(bytes_=w), Sym(bytes_=nw)))
        return node
    if isinstance(node, Cat):
        return Cat(tuple(_split_mixed_syms(p) for p in node.parts))
    if isinstance(node, Alt):
        return Alt(tuple(_split_mixed_syms(p) for p in node.parts))
    if isinstance(node, Star):
        return Star(_split_mixed_syms(node.inner))
    return node


def compile_patterns(patterns: list[str], ignore_case: bool = False) -> NFAProgram:
    """Compile K patterns into one union automaton (any-match
    semantics, ≙ RegexFilter's any(p.search(line))).

    Word-boundary assertions compile to STATIC structure — no runtime
    cost: mid-pattern \\b/\\B filter follow edges by the (category-pure,
    pre-split) endpoint categories; a leading assertion routes injection
    through always-injected context positions (active exactly when the
    previously consumed symbol had the matching category — BEGIN counts
    non-word); a trailing assertion routes acceptance through
    boundary-check positions that consume the NEXT symbol (END counts
    non-word). A pattern matching empty only AT a boundary (``\\b``,
    ``\\B``) wires context→check edges per adjacency relation, with the
    BEGIN→END pair excluded to mirror re's "\\B never matches the empty
    string" rule (Python 3.12 semantics, verified empirically)."""
    if not patterns:
        raise ValueError("compile_patterns needs at least one pattern")
    b = _Builder()
    inject: set[int] = set()
    accept: set[int] = set()
    begin_members: set[int] = set()  # extra positions in mask[BEGIN]
    end_members: set[int] = set()  # extra positions in mask[END]
    match_all = False

    # Lazily created special positions, shared across the union.
    # Context (always injected; exactly one active after every step):
    #   ctx[0] after BEGIN, ctx[1] after a non-word byte, ctx[2] after a
    #   word byte. Boundary-check accepts: bnd[0] consumes END, bnd[1] a
    #   non-word byte, bnd[2] a word byte.
    _NW = _ALL_BYTES - _CLASS_W
    specials: dict = {}

    def special(kind: str) -> int:
        p = specials.get(kind)
        if p is None:
            byte_set = {"ctx_begin": frozenset(), "ctx_nw": _NW,
                        "ctx_w": _CLASS_W, "bnd_end": frozenset(),
                        "bnd_nw": _NW, "bnd_w": _CLASS_W}[kind]
            p = specials[kind] = b.new_pos(byte_set)
            if kind.startswith("ctx"):
                inject.add(p)
                if kind == "ctx_begin":
                    begin_members.add(p)
            else:
                accept.add(p)
                if kind == "bnd_end":
                    end_members.add(p)
        return p

    def ctx_kinds(cat: int, target_is_end: bool, tag: int) -> list[str]:
        # Context kinds active when the PREVIOUS symbol had category
        # `cat`. The (ctx_begin, END-consuming target) pair IS the
        # empty-line adjacency, so it is included only when the
        # constraint admits _EMPTY (interpreter-probed; e.g. ^\B must
        # not match "" on re 3.12).
        if cat:
            return ["ctx_w"]
        if target_is_end and not tag & _EMPTY:
            return ["ctx_nw"]
        return ["ctx_begin", "ctx_nw"]

    def bnd_kinds(cat: int, source_is_begin: bool, tag: int) -> list[str]:
        # Boundary-check kinds consuming a NEXT symbol of category
        # `cat`; the (BEGIN source, bnd_end) pair is the empty-line
        # adjacency — same _EMPTY gate.
        if cat:
            return ["bnd_w"]
        if source_is_begin and not tag & _EMPTY:
            return ["bnd_nw"]
        return ["bnd_end", "bnd_nw"]

    for pat in patterns:
        ast = parse(pat, ignore_case=ignore_case)
        if _contains_boundary(ast):
            ast = _split_mixed_syms(ast)
        n0 = len(b.symbols)
        d0 = len(b.divergent)
        nulls, first, last = b.visit(ast)
        if len(b.divergent) > d0:
            raise RegexSyntaxError(_DIVERGENT_ANCHOR_MSG.format(pat=pat))
        match_all |= nulls == _FULL

        for j, tag in first:
            if tag == _FULL:
                inject.add(j)
                continue
            if b.symbols[j] is BEGIN:
                raise RegexSyntaxError(
                    f"word-boundary assertion before ^ in {pat!r} is not "
                    "supported (nothing precedes the BEGIN sentinel to "
                    "check the boundary against)")
            cj = b.cat(j)
            for c in (0, 1):  # category of the preceding symbol
                rel = _EQ if c == cj else _NEQ
                if rel & tag:
                    for k in ctx_kinds(c, b.symbols[j] is END, tag):
                        b.follow[special(k)].add(j)
        for i, tag in last:
            if tag == _FULL:
                accept.add(i)
                continue
            if b.symbols[i] is END:
                raise RegexSyntaxError(
                    f"word-boundary assertion after $ in {pat!r} is not "
                    "supported (nothing follows the END sentinel to "
                    "check the boundary against)")
            ci = b.cat(i)
            for c in (0, 1):  # category of the next symbol
                rel = _EQ if c == ci else _NEQ
                if rel & tag:
                    for k in bnd_kinds(c, b.symbols[i] is BEGIN, tag):
                        b.follow[i].add(special(k))
        if nulls != _FULL and nulls & (_EQ | _NEQ):
            # Empty match only AT a boundary/non-boundary adjacency
            # (standalone \b / \B): context→check edges for every
            # admitted (prev, next) category pair. The
            # ctx_begin→bnd_end pair is the empty-line adjacency and
            # follows the probed _EMPTY bit.
            for cp in ("ctx_begin", "ctx_nw", "ctx_w"):
                for cn in ("bnd_end", "bnd_nw", "bnd_w"):
                    if cp == "ctx_begin" and cn == "bnd_end":
                        rel = _EMPTY
                    else:
                        rel = (_EQ if (cp == "ctx_w") == (cn == "bnd_w")
                               else _NEQ)
                    if rel & nulls:
                        b.follow[special(cp)].add(special(cn))

    n = len(b.symbols)
    if n == 0:
        # Every pattern was pure-epsilon (e.g. "" or "()"): match-all
        # with a single dead state so array shapes stay non-degenerate.
        n = 1
        b.symbols.append(frozenset())
        b.follow.append(set())

    # --- byte-class compression -------------------------------------
    byte_sets = [s for s in b.symbols if isinstance(s, frozenset)]
    sig = np.zeros((256, len(byte_sets)), dtype=bool)
    for j, s in enumerate(byte_sets):
        for byte in s:
            sig[byte, j] = True
    _, byte_class = np.unique(sig, axis=0, return_inverse=True)
    byte_class = byte_class.astype(np.int32)
    n_byte_classes = int(byte_class.max()) + 1 if len(byte_sets) else 1
    begin_class = n_byte_classes
    end_class = n_byte_classes + 1
    pad_class = n_byte_classes + 2
    n_classes = n_byte_classes + 3

    char_mask = np.zeros((n_classes, n), dtype=bool)
    # One representative byte per class is enough: membership is
    # constant within a class by construction.
    rep_byte = np.zeros(n_byte_classes, dtype=np.int32)
    rep_byte[byte_class] = np.arange(256, dtype=np.int32)
    for s_idx, sym in enumerate(b.symbols):
        if sym == BEGIN:
            char_mask[begin_class, s_idx] = True
        elif sym == END:
            char_mask[end_class, s_idx] = True
        else:
            for c in range(n_byte_classes):
                if int(rep_byte[c]) in sym:
                    char_mask[c, s_idx] = True
    # Boundary machinery: ctx_begin is active after the BEGIN step,
    # bnd_end consumes the END sentinel (both also/only via these rows).
    for s_idx in begin_members:
        char_mask[begin_class, s_idx] = True
    for s_idx in end_members:
        char_mask[end_class, s_idx] = True

    follow = np.zeros((n, n), dtype=bool)
    for i, js in enumerate(b.follow):
        for j in js:
            follow[i, j] = True

    inject_v = np.zeros(n, dtype=bool)
    inject_v[list(inject)] = True
    accept_v = np.zeros(n, dtype=bool)
    accept_v[list(accept)] = True

    return NFAProgram(
        n_states=n,
        n_classes=n_classes,
        byte_class=byte_class,
        begin_class=begin_class,
        end_class=end_class,
        pad_class=pad_class,
        char_mask=char_mask,
        follow=follow,
        inject=inject_v,
        accept=accept_v,
        match_all=match_all,
        patterns=tuple(patterns),
    )


def reference_match(prog: NFAProgram, line: bytes) -> bool:
    """Pure-numpy oracle-shaped simulation of the exact update the
    GPU engine runs — used by property tests to separate 'automaton is
    wrong' from 'engine is wrong'."""
    if prog.match_all:
        return True
    classes = (
        [prog.begin_class]
        + [int(prog.byte_class[c]) for c in line]
        + [prog.end_class]
    )
    v = np.zeros(prog.n_states, dtype=bool)
    follow_u8 = prog.follow.astype(np.uint8)
    for c in classes:
        reach = (v.astype(np.uint8) @ follow_u8) > 0
        v = (reach | prog.inject) & prog.char_mask[c]
        if (v & prog.accept).any():
            return True
    return False
