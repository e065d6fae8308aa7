"""The port's host engines (``--backend cpu``) against the JAX package's:
``RegexFilter``, ``CombinedRegexFilter``, ``DFAFilter`` and the
``best_host_filter`` ladder (verdicts and chosen kind, across
``KLOGS_CPU_ENGINE`` and the group-reference rule), the DFA tables
field by field, and the on-disk table cache (hit, miss, evict, the LRU
cap, and the port's own directory). Verdicts are booleans: equality is
exact. The cache lives under ``tmp_path`` (``XDG_CACHE_HOME``)."""

import os
import re

import numpy as np
import pytest

from klogs_tpu.filters import cpu as jcpu
from klogs_tpu.filters.compiler import dfa as jdfa
from klogs_tpu.filters.compiler.glushkov import compile_patterns as jcompile
from klogs_tpu_torch.filters import cpu as pcpu
from klogs_tpu_torch.filters.compiler import dfa as pdfa
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns as pcompile

SEED = 20261018


@pytest.fixture(autouse=True)
def _hermetic_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    for k in ("KLOGS_CPU_ENGINE", "KLOGS_INDEX_MIN_K", "KLOGS_DFA_CACHE_MB",
              "KLOGS_NATIVE_SIMD", "KLOGS_NATIVE_GROUPSCAN"):
        monkeypatch.delenv(k, raising=False)


def corpus(n: int = 400, seed: int = SEED) -> "list[bytes]":
    """Seeded log-ish lines over a small alphabet, so patterns hit, with
    trailing newlines, empty lines and upper/lower case."""
    rng = np.random.default_rng(seed)
    words = [b"ERROR", b"error", b"WARN", b"info", b"abc", b"abcd", b"x1",
             b"code=503", b"latency=49ms", b"ab", b"ba", b"q", b"zq",
             b"Disk", b"disk full", b"job-00042", b"(", b"\\", b"xyz"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 7))
        line = b" ".join(words[int(i)] for i in rng.integers(0, len(words), k))
        out.append(line + b"\n" * int(rng.integers(0, 3)))
    return out


SETS = [
    ["ERROR"],
    ["error", r"code=50[34]"],
    [r"latency=4\dms", "^abc", r"disk\s+full$", "x[0-9]+"],
    [r"(ab|ba)+q", "zq?", r"\bjob-\d{5}\b"],
    ["."],
    ["^$"],
    ["a.*b.*c", r"[^a-z ]{3,}"],
]


@pytest.mark.parametrize("ignore_case", [False, True], ids=["case", "I"])
@pytest.mark.parametrize("pats", SETS, ids=lambda p: "|".join(p)[:24])
def test_engines_equal_jax(pats, ignore_case):
    lines = corpus()
    for name in ("RegexFilter", "CombinedRegexFilter", "DFAFilter"):
        p = getattr(pcpu, name)(pats, ignore_case=ignore_case)
        j = getattr(jcpu, name)(pats, ignore_case=ignore_case)
        assert p.match_lines(lines) == j.match_lines(lines), name
    oracle = [any(re.search(x.encode(), ln.rstrip(b"\n"),
                            re.I if ignore_case else 0) for x in pats)
              for ln in lines]
    assert pcpu.DFAFilter(pats, ignore_case=ignore_case).match_lines(
        lines) == oracle


KIND_SETS = {
    "dfa": ["ERROR", r"code=\d+"],
    "groupref": [r"(x)y\1", "ERROR"],
    "condref": ["(x)y", r"(a)?b(?(1)c|d)"],
    "named_ref": [r"(?P<w>ab)(?P=w)", "q"],
    "lookahead": [r"ERROR(?=\s)", "WARN"],
    "global_flag": ["(?i)error", "WARN"],
    "overflow": [r"(a|b)*a(a|b){14}"],
}


@pytest.mark.parametrize("engine", ["auto", "dfa", "combined", "re",
                                    "indexed"])
@pytest.mark.parametrize("name", sorted(KIND_SETS))
def test_best_host_filter_kind_and_verdicts_equal_jax(name, engine,
                                                      monkeypatch):
    """The ladder picks the kind JAX picks, under each KLOGS_CPU_ENGINE,
    and a forced rung that the set does not admit raises in both."""
    monkeypatch.setenv("KLOGS_CPU_ENGINE", engine)
    pats = KIND_SETS[name]
    lines = corpus(200) + [b"xyx", b"xyxx", b"abc", b"bd", b"abab q",
                           b"ERROR \n", b"a" * 20 + b"\n"]
    got = []
    for mod in (pcpu, jcpu):
        try:
            f, kind = mod.best_host_filter(pats)
        except Exception as e:  # noqa: BLE001 - compared across packages
            got.append(("raise", type(e).__name__))
            continue
        got.append((kind, f.match_lines(lines)))
    assert got[0][0] == got[1][0]
    assert got[0] == got[1]


def test_best_host_filter_indexed_from_min_k(monkeypatch):
    """Auto takes the indexed engine from KLOGS_INDEX_MIN_K patterns."""
    pats = [f"svc-{i:04d} down" for i in range(70)]
    assert pcpu.best_host_filter(pats)[1] == "indexed"
    monkeypatch.setenv("KLOGS_INDEX_MIN_K", "200")
    assert pcpu.best_host_filter(pats)[1] == "dfa"
    assert jcpu.best_host_filter(pats)[1] == "dfa"


def test_build_errors_propagate_through_the_ladder(monkeypatch):
    """Only an inadmissible set moves down the ladder: a C build error
    (NativeBuildError) out of the DFA rung propagates, where the JAX
    ladder catches every exception."""
    from klogs_tpu_torch import native

    def refuse():
        raise native.NativeBuildError("no compiler")

    monkeypatch.setattr(native, "hostops", refuse)
    with pytest.raises(native.NativeBuildError):
        pcpu.best_host_filter(["ERROR"])
    with pytest.raises(native.NativeBuildError):
        pcpu.best_host_filter([f"svc-{i:04d} down" for i in range(70)])


@pytest.mark.parametrize("pats", SETS + [list(KIND_SETS["dfa"])],
                         ids=lambda p: "|".join(p)[:24])
def test_dfa_tables_equal_jax(pats):
    for ic in (False, True):
        p = pdfa.build_dfa(pcompile(pats, ignore_case=ic))
        j = jdfa.build_dfa(jcompile(pats, ignore_case=ic))
        for field in ("table", "accept", "byte_class"):
            a, b = getattr(p, field), getattr(j, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        for field in ("n_classes", "start", "end_class", "match_all"):
            assert getattr(p, field) == getattr(j, field), field


def test_dfa_overflow_is_none_and_raises_in_the_filter():
    pats = KIND_SETS["overflow"]
    assert pdfa.build_dfa(pcompile(pats), max_states=64) is None
    with pytest.raises(pcpu.DFAStateOverflow):
        pcpu.DFAFilter(pats, max_states=64)
    with pytest.raises(jcpu.DFAStateOverflow):
        jcpu.DFAFilter(pats, max_states=64)


def test_dfa_filter_scan_equals_scan_python():
    """The C scan (the filter's only path) equals its plain version."""
    lines = corpus(600, seed=SEED + 1)
    for pats in SETS:
        f = pcpu.DFAFilter(pats, cache=False)
        assert f.match_lines(lines) == pdfa.scan_python(f.tables, lines)


def test_cache_dir_is_the_ports_own(tmp_path):
    from klogs_tpu.utils.cache import cache_dir as jdir
    from klogs_tpu_torch.utils.cache import cache_dir as pdir

    assert pdir() == os.path.join(str(tmp_path / "xdg"), "klogs-tpu-torch")
    assert os.path.dirname(pdir()) == os.path.dirname(jdir())
    assert pdir() != jdir()


def _events(mod, pats, **kw) -> "list[str]":
    ev: "list[str]" = []
    t = mod.build_dfa_cached(pats, on_event=ev.append, **kw)
    assert t is not None
    return ev


def test_cache_hit_miss_evict_equal_jax(monkeypatch):
    """The same sequence of builds gives the same events in both
    packages: miss then hit, and past KLOGS_DFA_CACHE_MB the LRU evicts
    the least recently used table (a hit refreshes it), never the one
    just written. Each package evicts only from its own directory."""
    a, b, c = ["ERROR"], [r"code=\d+"], ["WARN.*disk"]
    seqs, left = [], []
    for mod in (pdfa, jdfa):
        def path(p):
            return mod._cache_path(p, False, mod.DEFAULT_MAX_STATES)

        monkeypatch.delenv("KLOGS_DFA_CACHE_MB", raising=False)
        seq = _events(mod, a) + _events(mod, a) + _events(mod, b)
        os.utime(path(a), (1, 1))
        # Room for two tables: writing c evicts the oldest, a.
        size = max(os.path.getsize(path(p)) for p in (a, b))
        monkeypatch.setenv("KLOGS_DFA_CACHE_MB", str(2.5 * size / 1048576))
        seq += _events(mod, c)
        os.utime(path(c), (2, 2))
        # The hit refreshes b, so writing a again evicts c, not b.
        seq += _events(mod, b) + _events(mod, a) + _events(mod, b)
        seqs.append(seq)
        left.append(sorted(f for f in os.listdir(os.path.dirname(path(a)))
                           if f.startswith("dfa-")))
    assert seqs[0] == seqs[1]
    assert seqs[0] == ["miss", "hit", "miss", "miss", "evict", "hit",
                       "miss", "evict", "hit"]
    assert len(left[0]) == len(left[1]) == 2
    assert os.path.dirname(pdfa._cache_path(a, False, 1)) != \
        os.path.dirname(jdfa._cache_path(a, False, 1))


def test_cache_cap_knob_and_corrupt_file(monkeypatch):
    """A malformed or non-positive cap reads as the default, as in JAX;
    a corrupt cache file rebuilds (a miss) and is replaced."""
    for raw in ("x", "0", "-3", "nan"):
        monkeypatch.setenv("KLOGS_DFA_CACHE_MB", raw)
        assert pdfa._cache_cap_bytes() == jdfa._cache_cap_bytes() == \
            pdfa.DEFAULT_CACHE_MB * 1048576
    monkeypatch.setenv("KLOGS_DFA_CACHE_MB", "2.5")
    assert pdfa._cache_cap_bytes() == int(2.5 * 1048576)
    pats = ["ERROR"]
    assert _events(pdfa, pats) == ["miss"]
    path = pdfa._cache_path(pats, False, pdfa.DEFAULT_MAX_STATES)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    assert _events(pdfa, pats) == ["miss"]
    assert _events(pdfa, pats) == ["hit"]


def test_compiler_fingerprint_covers_the_ports_sources():
    """The key hashes the port's own compiler files: a cached table of
    the JAX package is never read as the port's."""
    assert pdfa._FINGERPRINT != jdfa._FINGERPRINT
    assert len(pdfa._FINGERPRINT) == 16
