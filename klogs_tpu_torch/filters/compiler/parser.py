"""Regex parser for the --match pattern compiler.

Parses the RE2-style subset (no backreferences, no lookaround) into a
small AST over *byte sets* and *sentinel symbols*. Anchors are not
assertions here: ``^`` and ``$`` parse to ordinary symbols matching
virtual BEGIN/END sentinels that the engine feeds around each line, so
Glushkov construction needs no special cases and patterns like ``a^b``
(never matches) or ``^a*$`` fall out correct by construction. The one
place symbol semantics would diverge from re's idempotent assertions —
an anchor directly (or across nullable-only content) after another
anchor, e.g. ``^^``, ``$$``, ``$^``, ``^a?^`` — is rejected at compile
time (glushkov), keeping the contract that every accepted pattern
behaves exactly like re.

Supported syntax: literals, ``.``, escapes (\\d \\D \\w \\W \\s \\S
\\t \\n \\r \\f \\v \\0 \\xHH and escaped punctuation), word-boundary
assertions ``\\b`` / ``\\B`` (compiled to static edge constraints in
glushkov.py — no runtime cost), character classes ``[...]`` with
ranges and negation (``[\\b]`` is backspace, as in re), grouping
``(...)`` / ``(?:...)`` / ``(?P<name>...)`` (captures are irrelevant
to boolean matching; duplicate names reject as in re), comments
``(?#...)``, scoped flag groups over ``i`` (ignore-case)
and ``s`` (DOTALL) — ``(?i:...)``, ``(?-i:...)``, ``(?s:...)``,
``(?i-s:...)`` etc. — alternation ``|``, quantifiers ``* + ? {m} {m,}
{m,n}`` (lazy variants accepted — laziness is irrelevant for boolean
matching), anchors ``^ $`` plus ``\\A`` / ``\\Z`` (≡ ^/$ in the
single-line bytes domain), and whole-pattern ``(?i)`` / ``(?s)`` /
``(?si)`` prefixes.

A copy of ``klogs_tpu.filters.compiler.parser``: the port keeps its
own compiler so it imports nothing of the JAX package. The behavioral
oracle is Python ``re``.
"""

from dataclasses import dataclass


class RegexSyntaxError(ValueError):
    pass


# Sentinel symbol kinds (distinct from any byte value).
BEGIN = "BEGIN"
END = "END"


@dataclass(frozen=True)
class Sym:
    """Leaf: matches one input symbol — either any byte in ``bytes_``
    (a frozenset of ints) or the BEGIN/END sentinel."""

    bytes_: frozenset = frozenset()
    sentinel: str | None = None


@dataclass(frozen=True)
class Epsilon:
    pass


@dataclass(frozen=True)
class Boundary:
    """Zero-width word-boundary assertion: ``\\b`` (negate=False)
    requires the adjacent symbols to differ in word-category,
    ``\\B`` (negate=True) requires them to agree. BEGIN/END sentinels
    count as non-word, exactly like re's edge-of-string rule."""

    negate: bool = False


@dataclass(frozen=True)
class Cat:
    parts: tuple


@dataclass(frozen=True)
class Alt:
    parts: tuple


@dataclass(frozen=True)
class Star:
    inner: object


def _is_bare_assertion(node: object) -> bool:
    """A bare anchor or \\b/\\B — re's 'nothing to repeat' targets;
    a group containing one ((?:\\b)?) is legal and wrapped in _atom."""
    return isinstance(node, Boundary) or (
        isinstance(node, Sym) and node.sentinel is not None)


_CLASS_D = frozenset(range(0x30, 0x3A))
_CLASS_W = _CLASS_D | frozenset(range(0x41, 0x5B)) | frozenset(range(0x61, 0x7B)) | {0x5F}
_CLASS_S = frozenset(b" \t\n\r\f\v")
_ALL_BYTES = frozenset(range(256))
_DOT = _ALL_BYTES - {0x0A}  # '.' excludes \n (re default, no DOTALL)

# Hard cap on AST leaf count after {m,n} expansion; the automaton state
# count equals the leaf count, and transition tables are quadratic in it
# (an unchecked quantifier nest would compile gigabyte tables). RE2
# analog: "program size too large". KLOGS_MAX_PATTERN_POSITIONS
# overrides it in BOTH directions — raise for legitimately huge
# patterns, lower to bound the device tables — and applies uniformly to the
# per-pattern cap here and the union-automaton cap in glushkov.py.
MAX_POSITIONS = 4096

# Regex features that are valid `re` but OUTSIDE this compiler's
# subset AND whose meaning depends on group NUMBERING: numbered
# backreferences, named backreferences, and conditional group
# references (kept identical to the JAX package's table).
GROUP_REF_TOKENS = (r"\\[1-9]", r"\(\?P=", r"\(\?\(")


def max_positions_cap() -> int:
    """Effective position cap (env override or MAX_POSITIONS). Read
    once per parse/build — not per leaf — by the callers."""
    from klogs_tpu_torch.utils.env import read as env_read

    s = env_read("KLOGS_MAX_PATTERN_POSITIONS")
    if s is None:
        return MAX_POSITIONS
    try:
        return max(1, int(s))
    except ValueError:
        # Deliberately NOT RegexSyntaxError: callers treat that as "bad
        # pattern" and soft-skip (the fuzzer would pass vacuously, the
        # CLI would blame --match). A config typo should crash loudly.
        raise ValueError(
            f"KLOGS_MAX_PATTERN_POSITIONS must be an integer, got {s!r}"
        ) from None


def _casefold(s: frozenset) -> frozenset:
    out = set(s)
    for b in s:
        if 0x41 <= b <= 0x5A:
            out.add(b + 0x20)
        elif 0x61 <= b <= 0x7A:
            out.add(b - 0x20)
    return frozenset(out)


class _Parser:
    def __init__(self, pattern: str, ignore_case: bool = False) -> None:
        # Patterns arrive as str from the CLI; we match raw bytes, so
        # encode utf-8 — the same bytes RegexFilter's re.compile(p.encode())
        # sees, making byte-wise parsing here exactly equivalent to the
        # CPU baseline (a non-ASCII literal becomes its utf-8 byte
        # sequence; quantifiers bind to the final byte, as in re).
        self.src = pattern.encode("utf-8")
        self.pos = 0
        self.ignore_case = ignore_case
        self.dotall = False
        self.n_leaves = 0
        self.group_names: set[bytes] = set()
        self.max_positions = max_positions_cap()  # read once per parse

    # -- low-level cursor ------------------------------------------------
    def _peek(self) -> int | None:
        return self.src[self.pos] if self.pos < len(self.src) else None

    def _next(self) -> int:
        if self.pos >= len(self.src):
            raise RegexSyntaxError("unexpected end of pattern")
        b = self.src[self.pos]
        self.pos += 1
        return b

    def _expect(self, ch: int) -> None:
        if self._peek() != ch:
            raise RegexSyntaxError(
                f"expected {chr(ch)!r} at position {self.pos} in {self.src!r}"
            )
        self.pos += 1

    def _leaf(self, **kw: object) -> Sym:
        self.n_leaves += 1
        if self.n_leaves > self.max_positions:
            raise RegexSyntaxError(
                f"pattern too large: more than {self.max_positions} "
                "positions (KLOGS_MAX_PATTERN_POSITIONS overrides the cap)"
            )
        return Sym(**kw)

    def _sym(self, byte_set: frozenset) -> Sym:
        if self.ignore_case:
            byte_set = _casefold(byte_set)
        return self._leaf(bytes_=byte_set)

    # -- grammar ---------------------------------------------------------
    _FLAG_ATTR = {0x69: "ignore_case", 0x73: "dotall"}  # i, s

    def _skip_comments(self) -> None:
        """Splice out ``(?#...)`` comments at the cursor. Comments are
        TRANSPARENT in re's token stream — a quantifier after one binds
        to the atom BEFORE it (``a(?#c)*b`` ≡ ``a*b``) — so they are
        consumed at the lexical level, never parsed as atoms. The first
        ')' ends a comment; EOF inside one is 'unexpected end'."""
        while self.src[self.pos:self.pos + 3] == b"(?#":
            self.pos += 3
            while self._next() != 0x29:  # ')'
                pass

    def _scan_flags(self) -> "tuple[list[int], list[int]] | None":
        """At a position just past ``(?``: consume ``[is]*(-[is]+)?:``
        and return (positive, negative) flag byte lists, or None (cursor
        restored) when this is not a flags/plain group — the caller
        rejects with the group-syntax message. An unknown flag letter is
        its own loud error, named. The plain ``(?:`` form is the empty
        case. Global ``(?i)``-style prefixes are handled in parse()."""
        start = self.pos
        pos_flags: list[int] = []
        neg_flags: list[int] = []
        bucket = pos_flags
        while True:
            c = self._peek()
            if c in self._FLAG_ATTR:
                self.pos += 1
                bucket.append(c)
            elif c == 0x2D and bucket is pos_flags:  # '-'
                self.pos += 1
                bucket = neg_flags
            elif c == 0x3A:  # ':'
                self.pos += 1
                if bucket is neg_flags and not neg_flags:
                    break  # '(?-:' — not a valid flags group
                if set(pos_flags) & set(neg_flags):
                    raise RegexSyntaxError(
                        "inline flag turned on and off in the same "
                        "group, as in re")
                return pos_flags, neg_flags
            elif c is not None and chr(c).isalpha():
                raise RegexSyntaxError(
                    f"unsupported inline flag {chr(c)!r} (only i and s)")
            else:
                break
        self.pos = start
        return None

    def parse(self) -> object:
        # Whole-pattern global flags — (?i) (?s) (?si) ... — at the
        # start only, as in re ("global flags not at the start of the
        # expression" is re's error for the misplaced form, which the
        # group parser rejects loudly here too).
        self._skip_comments()
        while self.src[self.pos:self.pos + 2] == b"(?":
            saved = self.pos
            self.pos += 2
            flags: list[int] = []
            while self._peek() in self._FLAG_ATTR:
                flags.append(self._next())
            if flags and self._peek() == 0x29:  # ')'
                self.pos += 1
                for f in flags:
                    setattr(self, self._FLAG_ATTR[f], True)
                self._skip_comments()
            else:
                self.pos = saved
                break
        node = self._alt()
        if self.pos != len(self.src):
            raise RegexSyntaxError(
                f"unbalanced ')' at position {self.pos} in {self.src!r}"
            )
        return node

    def _alt(self) -> object:
        parts = [self._concat()]
        while self._peek() == 0x7C:  # '|'
            self.pos += 1
            parts.append(self._concat())
        return parts[0] if len(parts) == 1 else Alt(tuple(parts))

    def _concat(self) -> object:
        parts = []
        while True:
            self._skip_comments()
            c = self._peek()
            if c is None or c in (0x7C, 0x29):  # '|' ')'
                break
            parts.append(self._repeat())
        if not parts:
            return Epsilon()
        return parts[0] if len(parts) == 1 else Cat(tuple(parts))

    def _repeat(self) -> object:
        node = self._atom()
        seen_quant = False
        while True:
            self._skip_comments()  # a(?#c)*b ≡ a*b: * binds to a
            c = self._peek()
            if c == 0x2A:  # '*'
                self._reject_bad_repeat(node, seen_quant)
                self.pos += 1
                node = Star(node)
            elif c == 0x2B:  # '+'
                self._reject_bad_repeat(node, seen_quant)
                node = Cat((node, Star(node)))
                self.pos += 1
            elif c == 0x3F:  # '?'
                self._reject_bad_repeat(node, seen_quant)
                self.pos += 1
                node = Alt((node, Epsilon()))
            elif c == 0x7B:  # '{'
                saved = self.pos
                rep = self._try_counted()
                if rep is None:
                    self.pos = saved
                    break
                self._reject_bad_repeat(node, seen_quant)
                lo, hi = rep
                node = self._expand_counted(node, lo, hi)
            else:
                break
            seen_quant = True
            # Lazy quantifier suffix ('+?' '*?' '??' '{m,n}?'): lazy vs
            # greedy picks WHICH match, not WHETHER one exists, so for
            # any-match semantics the language is identical — consume it.
            if self._peek() == 0x3F:
                self.pos += 1
        return node

    def _reject_bad_repeat(self, node: object, seen_quant: bool) -> None:
        """A quantifier directly following a quantifier is either re's
        POSSESSIVE form ('a++', 'a{2,3}+' — atomic, no backtracking,
        can reject strings the NFA language accepts, so an NFA cannot
        express it) or re's 'multiple repeat' error ('a**', 'a+*').
        Reject both, like RE2 — silently parsing 'X{2,3}+' as
        '(X{2,3})+' produced WRONG verdicts (found by fuzzing).
        A quantified bare anchor ('^*', '$+') is re's 'nothing to
        repeat' error and is rejected for the same parity reason."""
        if seen_quant:
            raise RegexSyntaxError(
                f"stacked or possessive quantifier at position {self.pos}"
                " is not supported (possessive/atomic matching cannot be"
                " expressed by an NFA; group with (?:...) if you meant"
                " nested repetition)")
        if _is_bare_assertion(node):
            raise RegexSyntaxError(
                f"nothing to repeat at position {self.pos} (quantifier"
                " applied to an anchor or \\b assertion, as in re)")

    def _try_counted(self) -> tuple[int, int | None] | None:
        """Parse {m} {m,} {m,n} after the '{'; None if not a counted
        repeat (then '{' is a literal, matching re's behavior)."""
        self._expect(0x7B)
        digits = b""
        while self._peek() is not None and 0x30 <= self._peek() <= 0x39:
            digits += bytes([self._next()])
        if not digits:
            return None
        lo = int(digits)
        hi: int | None = lo
        if self._peek() == 0x2C:  # ','
            self.pos += 1
            digits = b""
            while self._peek() is not None and 0x30 <= self._peek() <= 0x39:
                digits += bytes([self._next()])
            hi = int(digits) if digits else None
        if self._peek() != 0x7D:  # '}'
            return None
        self.pos += 1
        if hi is not None and hi < lo:
            raise RegexSyntaxError(f"bad repeat range {{{lo},{hi}}}")
        return lo, hi

    def _expand_counted(self, node: object, lo: int, hi: int | None) -> object:
        """e{m,n} → e^m (e?)^(n-m); e{m,} → e^m e*. Leaf-count safety:
        expansion revisits the same subtree, and Glushkov assigns fresh
        positions per visit, so count leaves here too."""
        n_inner = _count_leaves(node)
        total = n_inner * (hi if hi is not None else lo + 1)
        self.n_leaves += total - n_inner  # node's own leaves already counted
        if self.n_leaves > self.max_positions:
            raise RegexSyntaxError(
                f"pattern too large: counted repeat expands past "
                f"{self.max_positions} positions "
                "(KLOGS_MAX_PATTERN_POSITIONS overrides the cap)"
            )
        parts: list = [node] * lo
        if hi is None:
            parts.append(Star(node))
        else:
            parts.extend([Alt((node, Epsilon()))] * (hi - lo))
        if not parts:
            return Epsilon()
        return parts[0] if len(parts) == 1 else Cat(tuple(parts))

    def _atom(self) -> object:
        c = self._next()
        if c == 0x28:  # '('
            saved_flags: tuple | None = None
            if self._peek() == 0x3F:  # '(?'
                self.pos += 1
                n = self._peek()
                if n == 0x50:  # 'P' — (?P<name>...): captures are
                    # irrelevant to boolean matching, so a named group
                    # is just a group; backref forms stay rejected.
                    if self.src[self.pos:self.pos + 2] != b"P<":
                        raise RegexSyntaxError(
                            "only the (?P<name>...) ?P-form is supported "
                            "(no (?P=name) backreferences)")
                    self.pos += 2
                    name = b""
                    while self._peek() not in (None, 0x3E):  # '>'
                        name += bytes([self._next()])
                    self._expect(0x3E)
                    if (not name or not name.isascii()
                            or not name.decode("ascii").isidentifier()):
                        # re (bytes patterns) additionally rejects
                        # non-ASCII names — mirror it so the CPU re
                        # baseline compiles everything we accept.
                        raise RegexSyntaxError(
                            f"bad group name {name.decode('latin-1')!r}")
                    if name in self.group_names:
                        # re errors on redefinition; accepting here would
                        # compile patterns the CPU re baseline rejects.
                        raise RegexSyntaxError(
                            f"redefinition of group name "
                            f"{name.decode('latin-1')!r}, as in re")
                    self.group_names.add(name)
                    node = self._alt()
                    self._expect(0x29)
                    if _is_bare_assertion(node):
                        node = Cat((node,))
                    return node
                flags = self._scan_flags()
                if flags is None:
                    raise RegexSyntaxError(
                        "only (?:...) and (?i/s:...) flag groups supported "
                        "(no lookaround/named groups; global flags go at "
                        "the start, as in re)"
                    )
                saved_flags = (self.ignore_case, self.dotall)
                pos_flags, neg_flags = flags
                for f in pos_flags:
                    setattr(self, self._FLAG_ATTR[f], True)
                for f in neg_flags:
                    setattr(self, self._FLAG_ATTR[f], False)
            node = self._alt()
            if saved_flags is not None:
                self.ignore_case, self.dotall = saved_flags
            self._expect(0x29)
            if _is_bare_assertion(node):
                # re's "nothing to repeat" applies to a BARE anchor or
                # assertion, not a group containing one ((?:\b)? is
                # legal); a one-part Cat defeats _reject_bad_repeat
                # without changing the language.
                node = Cat((node,))
            return node
        if c == 0x5B:  # '['
            return self._char_class()
        if c == 0x2E:  # '.'
            return self._leaf(bytes_=_ALL_BYTES if self.dotall else _DOT)
        if c == 0x5E:  # '^'
            return self._leaf(sentinel=BEGIN)
        if c == 0x24:  # '$'
            return self._leaf(sentinel=END)
        if c == 0x5C:  # '\'
            n = self._peek()
            if n == 0x62:  # \b — word boundary (backspace inside [...])
                self.pos += 1
                return Boundary(negate=False)
            if n == 0x42:  # \B
                self.pos += 1
                return Boundary(negate=True)
            if n == 0x41:  # \A — start of string; ≡ ^ here (single-line
                self.pos += 1  # bytes domain, no MULTILINE)
                return self._leaf(sentinel=BEGIN)
            if n == 0x5A:  # \Z — end of string; ≡ $ (re bytes semantics)
                self.pos += 1
                return self._leaf(sentinel=END)
            return self._sym(self._escape(in_class=False))
        if c in (0x2A, 0x2B, 0x3F):  # quantifier with nothing to repeat
            raise RegexSyntaxError(f"nothing to repeat before {chr(c)!r}")
        return self._sym(frozenset({c}))

    def _escape(self, in_class: bool) -> frozenset:
        c = self._next()
        simple = {
            0x74: 0x09, 0x6E: 0x0A, 0x72: 0x0D,  # t n r
            0x66: 0x0C, 0x76: 0x0B, 0x30: 0x00,  # f v 0
            0x61: 0x07, 0x65: 0x1B,              # a e
        }
        if c in simple:
            return frozenset({simple[c]})
        if c == 0x78:  # \xHH
            h = bytes([self._next(), self._next()])
            try:
                return frozenset({int(h, 16)})
            except ValueError:
                raise RegexSyntaxError(f"bad hex escape \\x{h.decode('latin-1')}")
        classes = {
            0x64: _CLASS_D, 0x44: _ALL_BYTES - _CLASS_D,  # d D
            0x77: _CLASS_W, 0x57: _ALL_BYTES - _CLASS_W,  # w W
            0x73: _CLASS_S, 0x53: _ALL_BYTES - _CLASS_S,  # s S
        }
        if c in classes:
            return classes[c]
        if c == 0x62:  # \b: backspace inside a class (re semantics);
            # outside a class it is intercepted in _atom as Boundary.
            if in_class:
                return frozenset({0x08})
            raise RegexSyntaxError("internal: \\b must be handled in _atom")
        if chr(c).isalnum():
            # Includes [\B]: re rejects it as a bad escape in a class.
            raise RegexSyntaxError(f"unsupported escape \\{chr(c)}")
        return frozenset({c})  # escaped punctuation

    def _char_class(self) -> Sym:
        negate = False
        if self._peek() == 0x5E:  # '^'
            negate = True
            self.pos += 1
        members: set[int] = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise RegexSyntaxError("unterminated character class")
            if c == 0x5D and not first:  # ']'
                self.pos += 1
                break
            first = False
            self.pos += 1
            if c == 0x5C:
                lo_set = self._escape(in_class=True)
                if len(lo_set) != 1:
                    members |= lo_set  # \d etc. inside class: no range
                    continue
                (lo,) = lo_set
            else:
                lo = c
            if self._peek() == 0x2D and self.pos + 1 < len(self.src) and self.src[self.pos + 1] != 0x5D:
                self.pos += 1  # '-'
                hc = self._next()
                if hc == 0x5C:
                    hi_set = self._escape(in_class=True)
                    if len(hi_set) != 1:
                        raise RegexSyntaxError("bad character range endpoint")
                    (hi,) = hi_set
                else:
                    hi = hc
                if hi < lo:
                    raise RegexSyntaxError(f"bad character range {chr(lo)}-{chr(hi)}")
                members |= set(range(lo, hi + 1))
            else:
                members.add(lo)
        result = frozenset(members)
        # Casefold BEFORE negation: (?i)[^a] must exclude both 'a' and
        # 'A' (re semantics); folding after negation would re-add them.
        if self.ignore_case:
            result = _casefold(result)
        if negate:
            result = _ALL_BYTES - result
        if not result:
            raise RegexSyntaxError("empty character class matches nothing")
        return self._leaf(bytes_=result)


def _count_leaves(node: object) -> int:
    if isinstance(node, Sym):
        return 1
    if isinstance(node, (Epsilon, Boundary)):
        return 0
    if isinstance(node, (Cat, Alt)):
        return sum(_count_leaves(p) for p in node.parts)
    if isinstance(node, Star):
        return _count_leaves(node.inner)
    raise TypeError(node)


def parse(pattern: str, ignore_case: bool = False) -> object:
    """Parse one pattern into the AST. Raises RegexSyntaxError on
    unsupported or malformed syntax."""
    return _Parser(pattern, ignore_case=ignore_case).parse()
