"""CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.filters.gpu import GpuEngineFilter
from klogs_tpu_torch.ops import nfa, nfa_kernels, pack

pytestmark = pytest.mark.cuda

PATTERNS = ["panic:", r"retry \d+/\d+", "code=50[34]", "^start", "end$",
            r"(?:FATAL|CRIT).*code=\d+", "disk .*full"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def random_cls(prog, B: int, T: int, seed: int) -> torch.Tensor:
    """Class ids in the kernel layout, with some out-of-range ids."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, prog.n_classes - 3, size=(B, T))
    cls[:, 0] = prog.begin_class
    cls[:, -2] = prog.end_class
    cls[:, -1] = prog.pad_class
    cls[::17, T // 2] = prog.n_classes + 5
    cls[5::23, T // 3] = -1
    return torch.from_numpy(cls.astype(np.int16))


def text_cls(prog, B: int, width: int, needles: list, seed: int, dev):
    """Class ids of printable rows (lengths in [0, width], a needle in
    every other row) classified on the card, T = width + 3, with ids
    outside [0, C) in some rows."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(32, 127, size=(B, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, size=B).astype(np.int32)
    for i in range(0, B, 2):
        nd = needles[(i // 2) % len(needles)][:width]
        if lens[i] >= len(nd):
            p = int(rng.integers(0, lens[i] - len(nd) + 1))
            rows[i, p:p + len(nd)] = np.frombuffer(nd, np.uint8)
    cls = nfa.classify_chunk(prog, torch.from_numpy(rows).to(dev),
                             torch.from_numpy(lens).to(dev), True, True)
    cls[3::11, (width + 3) // 3] = prog.n_classes + 5
    cls[6::13, (width + 3) // 2] = -1
    return cls


# An exception-heavy set (alternations, stars, classes: many states
# with edges other than a shift or a self-loop) and a literal whose
# states cross the word edges 31/32 and 63/64.
EXC_PATS = [r"(a|b|c)+d", r"x.*y.*z", r"(foo|bar|baz)qux",
            r"[0-9]+(\.[0-9]+)*e", r"(ab|cd)*ef", r"(?:FATAL|CRIT).*code=\d+",
            r"k(e|i)+y", "disk .*full"]
EXC_NEEDLES = [b"abcd", b"x1y2z", b"bazqux", b"1.2.3e", b"abcdef",
               b"CRIT at code=4", b"keiy", b"disk is full"]
EDGE_PATS = ["abcdefghijklmnopqrstuvwxyz0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ",
             "panic:"]
EDGE_NEEDLES = [EDGE_PATS[0].encode(), EDGE_PATS[0][:40].encode(), b"panic:"]
# K1 and K4 cases: (patterns, needles) at W = 4, 8, 16, 32 (640 states
# padded to 1024) and past 32 words.
W_CASES = {
    4: (PATTERNS, [b"panic: x", b"retry 3/5", b"FATAL a code=9",
                   b"disk is full"]),
    8: (["a" * 200 + "b", r"x\d+y"], [b"a" * 200 + b"b", b"x12y"]),
    16: (["b" * 400 + "c", "panic:"], [b"b" * 400 + b"c", b"panic:"]),
    32: (["q" * 600 + "z", "panic:"], [b"q" * 600 + b"z", b"panic:"]),
    "wide": (["q" * 1100 + "z", "panic:"], [b"q" * 1100 + b"z", b"panic:"]),
}


def grouped_batches(prog, needles, dev):
    """Random ids at B = 1, 33, 1000 (T odd: rows of int16 not 4-byte
    aligned), then text rows at B = 33 and 1000."""
    width = (max(len(n) for n in needles) + 39) // 2 * 2  # T odd
    for B, T in ((1, 5), (33, 67), (1000, 131)):
        yield random_cls(prog, B, T, B).to(dev)
    for B in (33, 1000):
        yield text_cls(prog, B, width, needles, B, dev)


@pytest.mark.parametrize("patterns,needles", [
    W_CASES[4], W_CASES[8], W_CASES[16], W_CASES[32], W_CASES["wide"],
    (EXC_PATS, EXC_NEEDLES), (EDGE_PATS, EDGE_NEEDLES),
], ids=["s128", "s256", "s512", "s640", "wide", "exceptions", "word_edge"])
def test_grouped_kernel_equals_plain(dev, patterns, needles):
    """K1 equals its plain version at each register width, past them, on
    an exception-heavy set and across word edges, over random and text
    class ids with ids outside [0, C)."""
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    matched = 0
    for cls in grouped_batches(prog, needles, dev):
        got = nfa_kernels.match_cls_grouped(prog, live, acc, cls)
        exp = nfa_kernels.match_cls_grouped_plain(prog, live, acc, cls)
        assert got.dtype == torch.bool and got.shape == (cls.shape[0],)
        assert torch.equal(got, exp)
        matched += int(got.sum())
    assert matched > 0


def chunk_rows(B: int, L: int, n_chunks: int, needle: bytes, seed: int):
    """[B, n_chunks * L] printable rows and lengths for chained chunks:
    row 0 a dense-state line (700 q's, then z), every 7th from row 1
    ending on a chunk edge, the needle planted in every 5th from row 2."""
    rng = np.random.default_rng(seed)
    width = n_chunks * L
    rows = rng.integers(32, 127, size=(B, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, size=B)
    lens[1::7] = L * rng.integers(1, n_chunks + 1, size=len(lens[1::7]))
    for i in range(2, B, 5):
        if lens[i] >= len(needle):
            p = int(rng.integers(0, lens[i] - len(needle) + 1))
            rows[i, p:p + len(needle)] = np.frombuffer(needle, np.uint8)
    rows[0, :700] = ord("q")
    rows[0, 700] = ord("z")
    lens[0] = 701
    return rows, lens.astype(np.int32)


@pytest.mark.parametrize("B", [1, 8, 33, 1024])
@pytest.mark.parametrize("patterns,needle", [
    (PATTERNS, b"panic: x"),  # 128 states, W = 4
    (["a" * 200 + "b", r"x\d+y"], b"x123y"),  # 256, W = 8
    (None, b"code=503"),  # the 32 bench patterns: 512, W = 16
    (["q" * 600 + "z", "panic:"], b"panic:"),  # 640, run at W = 32
    (["w" * 1100 + "k", "EPIPE"], b"EPIPE"),  # 1152: the wide kernel
], ids=["w4", "w8", "w16", "w32", "wide"])
def test_chunk_kernel_equals_plain_chained(dev, patterns, needle, B):
    """K2 equals its plain version bit for bit, carries and matched,
    chained over 3 chunks of real class ids: lines ending on a chunk
    edge, a ragged last block (B = 33) and blocks of several warps, a
    dense-state line (row 0: with q{600}z, hundreds of set bits a step
    over many words), and class ids outside [0, C) (-1 and C + 5) in
    the middle chunk."""
    if patterns is None:
        from chip_smoke import PATTERNS as patterns  # = bench.PATTERNS
    union = compile_patterns(patterns)
    prog = nfa.pack_program(nfa.augment(union), device=dev)
    live, acc = union.n_states, union.n_states + 1
    L, n_chunks = 256, 3
    rows, lens = chunk_rows(B, L, n_chunks, needle, B)
    rows_d = torch.from_numpy(rows).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    v = nfa_kernels.initial_state(prog, live, B)
    vp = v.clone()
    for k in range(n_chunks):
        final = k == n_chunks - 1
        chunk = rows_d[:, k * L:(k + 1) * L].contiguous()
        cls = nfa.classify_chunk(prog, chunk, lens_d - k * L, k == 0, final)
        if k == 1:
            cls[4::17, 5] = prog.n_classes + 5
            cls[3::19, 9] = -1
        v, m = nfa_kernels.match_chunk_cls(prog, acc, cls, v, final=final)
        vp, mp = nfa_kernels.match_chunk_cls_plain(prog, acc, cls, vp)
        if final and prog.match_all:
            mp = torch.ones_like(mp)
        assert v.dtype == torch.int8 and v.shape == (B, prog.n_states)
        assert torch.equal(v, vp) and torch.equal(m, mp)
    if B >= 8:
        assert m.any() and not m.all()
    if patterns[0].startswith("q" * 600):
        assert bool(m[0])


@pytest.mark.parametrize("B", [1, 8, 33])
@pytest.mark.parametrize("patterns,needle,max_positions", [
    (PATTERNS + EXC_PATS, b"panic: x", 24),  # 128-state groups, W = 4
    (["a" * 200 + "b", r"x\d+y", "panic:"], b"x123y", 126),  # 256, W = 8
], ids=["w4", "w8"])
def test_grouped_chunk_kernel_equals_plain_chained(dev, patterns, needle,
                                                   max_positions, B):
    """K2g equals its plain version bit for bit, carries and verdicts,
    chained over 3 chunks of real class ids: several groups, lines
    ending on a chunk edge, a ragged last block (B = 33), a dense-state
    line (row 0), and class ids outside [0, C) in the middle chunk; one
    launch a chunk."""
    prog, live, acc = nfa.compile_grouped(patterns,
                                          max_positions=max_positions,
                                          device=dev)
    assert prog.follow.shape[0] > 1
    L, n_chunks = 256, 3
    rows, lens = chunk_rows(B, L, n_chunks, needle, B)
    rows_d = torch.from_numpy(rows).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    v = nfa_kernels.initial_state_grouped(prog, live, B)
    vp = v.clone()
    nfa_kernels.reset_launches()
    for k in range(n_chunks):
        final = k == n_chunks - 1
        chunk = rows_d[:, k * L:(k + 1) * L].contiguous()
        cls = nfa.classify_chunk(prog, chunk, lens_d - k * L, k == 0, final)
        if k == 1:
            cls[4::17, 5] = prog.n_classes + 5
            cls[3::19, 9] = -1
        v, m = nfa_kernels.match_chunk_cls_grouped(prog, live, acc, cls, v,
                                                   final=final)
        vp, mp = nfa_kernels.match_chunk_cls_grouped_plain(prog, live, acc,
                                                           cls, vp)
        assert v.dtype == torch.int32 and v.shape == vp.shape
        assert torch.equal(v, vp) and torch.equal(m, mp)
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED_CHUNK] == n_chunks
    if B >= 8:
        assert m.any() and not m.all()


def test_engine_long_lines_take_k2g_past_1024_states(dev):
    """80 patterns (a union of 1,298 states): the engine's long lines
    run K2g, never K2, and get the CPU engine's verdicts."""
    from chip_smoke import make_patterns, minted_needle

    pats = make_patterns(80)
    rng = np.random.default_rng(80)
    lines = []
    for i in range(12):
        n = int(rng.integers(4097, 3 * 4096))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        if i % 2:
            nd = minted_needle(int(rng.integers(0, 60)))
            p = int(rng.integers(0, n - len(nd)))
            body[p:p + len(nd)] = nd
        lines.append(bytes(body))
    lines += [b"svc-0040 unreachable", b"nothing"]
    card = GpuEngineFilter(pats, device=dev)
    assert card._long is not None and card._aug is None
    nfa_kernels.reset_launches()
    got = card.match_lines(lines)
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED_CHUNK] == 3
    assert nfa_kernels.LAUNCHES[nfa_kernels.CHUNK] == 0
    assert got == GpuEngineFilter(pats, device="cpu").match_lines(lines)
    assert any(got[:12]) and not all(got[:12])


# ---- K1 and K2g past 32 words: the wide shift kernels ----------------

# (patterns, needles, dense line) past 32 words: 36 (the watch list's
# width: chip_smoke.WATCH and a few exception-heavy patterns), 40 (the
# s1280 program), 48, 72, 128 and 132 words: 2 to 5 words a lane. The
# dense line sets hundreds of states a step (every unanchored start of
# the q run), or all 128 watch-list branches for five steps.
WIDE_CASES = {
    36: (None, [b"pod=pod-0001", b"x pod=pod-0255", b"abcd", b"bazqux",
                b"pod=pod-0002"], b"pod=pod-0129"),
    40: (["q" * 1200 + "z", "panic:"], [b"panic: x"], b"q" * 1200 + b"z"),
    48: (["q" * 1500 + "z", r"x\d+y"], [b"x12y"], b"q" * 1500 + b"z"),
    72: (["q" * 2200 + "z", "panic:"], [b"panic:"], b"q" * 2200 + b"z"),
    128: (["q" * 4000 + "z", "panic:"], [b"panic:"], b"q" * 4000 + b"z"),
    132: (["q" * 4094 + "z", "panic:"], [b"panic:"], b"q" * 4094 + b"z"),
    # Past 160 words, the state in shared memory: a watch list of 700
    # pods (176 words, C = 64: the tables read through L1), dense
    # literals at 264 words (C = 16: staged) and 520 (through L1).
    176: (700, [b"pod=pod-0001", b"x pod=pod-1399 y", b"pod=pod-0700",
                b"abcd", b"bazqux", b"pod=pod-0641"], b"pod=pod-1397"),
    264: (["q" * 8400 + "z", "panic:"], [b"panic:"], b"q" * 8400 + b"z"),
    520: (["q" * 16600 + "z", "panic:"], [b"panic:"], b"q" * 16600 + b"z"),
}
# The widths whose sets need KLOGS_MAX_PATTERN_POSITIONS past 4096.
SMEM_WORDS = [w for w in sorted(WIDE_CASES) if w > 160]


def wide_case(words: int, monkeypatch=None):
    """(patterns, needles, dense line) of a WIDE_CASES width; past 160
    words it raises the position cap through ``monkeypatch``."""
    from chip_smoke import WATCH, watch_list

    patterns, needles, dense = WIDE_CASES[words]
    if words > 160:
        monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    if isinstance(patterns, int):
        return [watch_list(patterns)] + EXC_PATS[:3], needles, dense
    return patterns or [WATCH] + EXC_PATS[:3], needles, dense


def route_names(words: int, kernel: str) -> tuple:
    """(the count name of ``kernel`` (k1, k2g, k3, k4) at ``words`` state
    words, the names of its other routes)."""
    names = nfa_kernels._NAMES
    route = nfa_kernels._route(words)
    return (names[route][kernel],
            [names[r][kernel] for r in names if r != route])


def wide_rows(B: int, width: int, needles: list, dense: bytes, seed: int):
    """[B, width] printable rows, lengths in [0, width], a needle in every
    other row from row 2; row 0 the dense line (a match), row 1 the dense
    line with its last byte changed (no match)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(32, 127, size=(B, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, size=B)
    for i in range(2, B, 2):
        nd = needles[(i // 2) % len(needles)]
        if lens[i] >= len(nd):
            p = int(rng.integers(0, lens[i] - len(nd) + 1))
            rows[i, p:p + len(nd)] = np.frombuffer(nd, np.uint8)
    for i, line in enumerate((dense, dense[:-1] + b"~")):
        rows[i, :len(line)] = np.frombuffer(line, np.uint8)
        lens[i] = len(line)
    return rows, lens.astype(np.int32)


def wide_batches(prog, words: int, needles: list, dense: bytes, dev):
    """Random class ids at B = 1, 33 and 200, then text rows with the
    dense line (64 rows; 16 past 264 words, where the plain version's
    dense steps cost ~1 PFLOP at 64), with ids outside [0, C) (C + 5 and
    -1)."""
    batches = [random_cls(prog, B, T, B).to(dev)
               for B, T in ((1, 5), (33, 67), (200, 131))]
    rows, lens = wide_rows(64 if words <= 264 else 16, len(dense) + 40,
                           needles, dense, words)
    cls = nfa.classify_chunk(prog, torch.from_numpy(rows).to(dev),
                             torch.from_numpy(lens).to(dev), True, True)
    T = cls.shape[1]
    cls[3::11, T // 3] = prog.n_classes + 5
    cls[5::13, T // 2] = -1
    return batches + [cls]


@pytest.mark.parametrize("words", sorted(WIDE_CASES))
def test_wide_grouped_kernel_equals_plain(dev, words, monkeypatch):
    """K1 past 32 words (``grouped_shift_wide_kernel``; past 160
    ``grouped_shift_smem_kernel``) equals its plain version on
    ``wide_batches``; every launch is that route's kernel's."""
    patterns, needles, dense = wide_case(words, monkeypatch)
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    assert nfa_kernels.kernel_states(prog.n_states) == 32 * words
    batches = wide_batches(prog, words, needles, dense, dev)
    name, others = route_names(words, "k1")
    nfa_kernels.reset_launches()
    for cls in batches:
        got = nfa_kernels.match_cls_grouped(prog, live, acc, cls)
        exp = nfa_kernels.match_cls_grouped_plain(prog, live, acc, cls)
        assert got.dtype == torch.bool and got.shape == (cls.shape[0],)
        assert torch.equal(got, exp)
    assert nfa_kernels.LAUNCHES[name] == len(batches)
    assert not any(nfa_kernels.LAUNCHES[n] for n in others)
    assert got[0] and not got[1] and got[2:].any() and not got.all()


@pytest.mark.parametrize("words", SMEM_WORDS)
def test_smem_fused_kernel_equals_plain_and_k1(dev, words, monkeypatch):
    """K4 past 160 words (``grouped_fused_smem_kernel``) equals its plain
    version and K1 on ``wide_batches``; K4's launches are its own."""
    patterns, needles, dense = wide_case(words, monkeypatch)
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    batches = wide_batches(prog, words, needles, dense, dev)
    nfa_kernels.reset_launches()
    for cls in batches:
        got = nfa_kernels.match_cls_grouped_fused(prog, live, acc, cls)
        assert torch.equal(got, nfa_kernels.match_cls_grouped_fused_plain(
            prog, live, acc, cls))
        assert torch.equal(got, nfa_kernels.match_cls_grouped(prog, live,
                                                              acc, cls))
    assert nfa_kernels.LAUNCHES[nfa_kernels.FUSED_SMEM] == len(batches)
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED_SMEM] == len(batches)
    assert nfa_kernels.LAUNCHES[nfa_kernels.FUSED_WIDE] == 0
    assert got[0] and not got[1] and got[2:].any() and not got.all()


@pytest.mark.parametrize("words,B", [
    (w, B) for w in sorted(WIDE_CASES) for B in (1, 8, 33)
    if w <= 264 or B <= 8])  # 520 x 33: ~0.6 PFLOP of plain steps
def test_wide_grouped_chunk_kernel_equals_plain_chained(dev, words, B,
                                                        monkeypatch):
    """K2g past 32 words (``grouped_chunk_wide_kernel``; past 160
    ``grouped_chunk_smem_kernel``) equals its plain version bit for bit,
    carries and verdicts, chained over the chunks of text rows (the dense
    line crossing chunk edges in row 0), with ids outside [0, C) in the
    second chunk (an id outside kills every state, acc too); one launch
    a chunk, of that route's kernel."""
    patterns, needles, dense = wide_case(words, monkeypatch)
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    rows, lens = wide_rows(max(B, 3), len(dense) + 700, needles, dense,
                           words + B)
    rows, lens = rows[:B], lens[:B]
    L = 512
    n_chunks = -(-rows.shape[1] // L)
    rows_d = torch.from_numpy(rows).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    v = nfa_kernels.initial_state_grouped(prog, live, B)
    vp = v.clone()
    nfa_kernels.reset_launches()
    for k in range(n_chunks):
        final = k == n_chunks - 1
        chunk = rows_d[:, k * L:(k + 1) * L].contiguous()
        cls = nfa.classify_chunk(prog, chunk, lens_d - k * L, k == 0, final)
        if k == 1:  # rows 0 and 2 keep their verdicts
            cls[3::3, 5] = prog.n_classes + 5
            cls[1::3, 9] = -1
        v, m = nfa_kernels.match_chunk_cls_grouped(prog, live, acc, cls, v,
                                                   final=final)
        vp, mp = nfa_kernels.match_chunk_cls_grouped_plain(prog, live, acc,
                                                           cls, vp)
        assert v.dtype == torch.int32 and v.shape == (B, prog.follow.shape[0],
                                                      words)
        assert torch.equal(v, vp) and torch.equal(m, mp)
    name, others = route_names(words, "k2g")
    assert nfa_kernels.LAUNCHES[name] == n_chunks
    assert not any(nfa_kernels.LAUNCHES[n] for n in others)
    assert bool(m[0]) and (B < 2 or not bool(m[1]))


def test_engine_wide_set_on_card_equals_re(dev):
    """The 32 bench patterns and the watch list (5 groups of 36 words):
    short lines launch K1's wide kernel, long lines K2g's, never K2 (no
    union is built), and every verdict is ``re``'s."""
    import re

    from chip_smoke import PATTERNS as bench, WATCH

    from klogs_tpu_torch.cluster.fake import synthetic_line

    pats = bench + [WATCH]
    rng = np.random.default_rng(36)
    lines = [synthetic_line(f"pod-{i % 300:04d}", "c0", i, 1.7e9 + i)
             for i in range(3000)]
    for i in range(8):
        n = int(rng.integers(4097, 12 * 1024))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        nd = b"pod=pod-%04d" % (2 * i + 1 + (i % 3 == 0))
        p = 4096 - 6 if i == 1 else int(rng.integers(0, n - len(nd)))
        body[p:p + len(nd)] = nd
        lines.append(bytes(body))
    card = GpuEngineFilter(pats, device=dev)
    assert card._long is not None and card._aug is None
    nfa_kernels.reset_launches()
    got = card.match_lines(lines)
    launches = dict(nfa_kernels.LAUNCHES)
    assert launches[nfa_kernels.GROUPED_WIDE] > 0
    assert launches[nfa_kernels.GROUPED_CHUNK_WIDE] >= 2
    assert launches[nfa_kernels.GROUPED] == 0
    assert launches[nfa_kernels.CHUNK] == 0
    alt = re.compile(b"|".join(b"(?:" + p.encode() + b")" for p in pats))
    assert got == [alt.search(ln.rstrip(b"\n")) is not None for ln in lines]
    assert any(got[-8:]) and not all(got[-8:])


def test_engine_k1024_watch_on_card_equals_re(dev, monkeypatch):
    """``make_patterns(1024)`` and the watch list: every one of the 157
    groups at 36 words, the sweep on (auto, K >= 64 on cuda). Short
    lines run K3's wide kernel (``grouped_gated_wide_kernel``), long
    lines K2g's (the union, ~20k states, is never built); the register
    K3, K1 (either width) and K2 never launch; every verdict is
    ``re``'s."""
    import re

    from chip_smoke import WATCH, make_patterns, minted_needle

    from klogs_tpu_torch.cluster.fake import synthetic_line

    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    pats = make_patterns(1024) + [WATCH]
    rng = np.random.default_rng(1025)
    lines = [synthetic_line(f"pod-{i % 300:04d}", "c0", i, 1.7e9 + i)
             for i in range(4000)]
    for i in range(3, 4000, 50):
        lines[i] = lines[i][:30] + minted_needle(int(rng.integers(0, 1200))) \
            + lines[i][30:]
    for i in range(6):
        n = int(rng.integers(4097, 12 * 1024))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        nd = (b"pod=pod-%04d" % (2 * i + 1) if i % 2
              else minted_needle(int(rng.integers(0, 992))))
        p = 4096 - 5 if i == 1 else int(rng.integers(0, n - len(nd)))
        body[p:p + len(nd)] = nd
        lines.append(bytes(body))
    card = GpuEngineFilter(pats, device=dev)
    assert card._sweep_tables is not None
    assert card._grouped.follow.shape[0] == 157
    assert nfa_kernels.grouped_state_words(card._grouped) == 36
    assert card._long is not None and card._aug is None
    nfa_kernels.reset_launches()
    got = card.match_lines(lines)
    launches = dict(nfa_kernels.LAUNCHES)
    assert launches[nfa_kernels.GATED_WIDE] > 0
    assert launches[nfa_kernels.GROUPED_CHUNK_WIDE] > 0
    for name in (nfa_kernels.GATED, nfa_kernels.GROUPED,
                 nfa_kernels.GROUPED_WIDE, nfa_kernels.CHUNK):
        assert launches[name] == 0, name
    alt = re.compile(b"|".join(b"(?:" + p.encode() + b")" for p in pats))
    assert got == [alt.search(ln.rstrip(b"\n")) is not None for ln in lines]
    assert any(got[:4000]) and not all(got[:4000])
    assert any(got[-6:]) and not all(got[-6:])


def watch700_lines(rng, n_short: int, long_needles: list) -> list:
    """FakeCluster lines of 300 pods (pod-0000 to pod-0299: every other
    one on a 700-pod watch list) and one long line of 4-12 KiB a needle,
    the second one ending 2 bytes past the 4096-byte chunk edge."""
    from klogs_tpu_torch.cluster.fake import synthetic_line

    lines = [synthetic_line(f"pod-{i % 300:04d}", "c0", i, 1.7e9 + i)
             for i in range(n_short)]
    for i, nd in enumerate(long_needles):
        n = int(rng.integers(4097, 12 * 1024))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        p = 4096 + 2 - len(nd) if i == 1 else int(rng.integers(0, n - len(nd)))
        body[p:p + len(nd)] = nd
        lines.append(bytes(body))
    return lines


def test_engine_watch700_on_card_equals_re(dev, monkeypatch):
    """The 32 bench patterns and a 700-pod watch list (5 groups of 176
    words, past 160): short lines launch K1's shared-memory kernel, long
    lines K2g's (no union is built: K2 never launches), and every
    verdict is ``re``'s."""
    import re

    from chip_smoke import PATTERNS as bench, watch_list

    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    pats = bench + [watch_list(700)]
    lines = watch700_lines(np.random.default_rng(700), 3000,
                           [b"pod=pod-1399", b"pod=pod-0641", b"pod=pod-0642",
                            b"oom-killer", b"pod=pod-14", b"panic: x"])
    card = GpuEngineFilter(pats, device=dev)
    assert nfa_kernels.grouped_state_words(card._grouped) == 176
    assert card._long is not None and card._aug is None
    nfa_kernels.reset_launches()
    got = card.match_lines(lines)
    launches = dict(nfa_kernels.LAUNCHES)
    assert launches[nfa_kernels.GROUPED_SMEM] > 0
    assert launches[nfa_kernels.GROUPED_CHUNK_SMEM] >= 2
    for name in (nfa_kernels.GROUPED, nfa_kernels.GROUPED_WIDE,
                 nfa_kernels.GROUPED_CHUNK_WIDE, nfa_kernels.CHUNK):
        assert launches[name] == 0, name
    alt = re.compile(b"|".join(b"(?:" + p.encode() + b")" for p in pats))
    assert got == [alt.search(ln.rstrip(b"\n")) is not None for ln in lines]
    assert any(got[:3000]) and not all(got[:3000])
    assert any(got[-6:]) and not all(got[-6:])


def test_engine_k64_watch700_on_card_equals_re(dev, monkeypatch):
    """``make_patterns(64)`` and a 700-pod watch list (every group at 176
    words) under the sweep (auto, K >= 64 on cuda): short lines run K3's
    shared-memory kernel, held against its plain version on the sweep's
    own gate, long lines K2g's; K1, the other K3 routes and K2 never
    launch; every verdict is ``re``'s."""
    import re

    from chip_smoke import make_patterns, minted_needle, watch_list

    from klogs_tpu_torch.ops import sweep

    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    pats = make_patterns(64) + [watch_list(700)]
    rng = np.random.default_rng(64700)
    lines = watch700_lines(rng, 2000, [b"pod=pod-0001", minted_needle(40),
                                       b"pod=pod-0002", b"svc-0009 x"])
    for i in range(3, 2000, 40):
        lines[i] = lines[i][:30] + minted_needle(int(rng.integers(0, 32))) \
            + lines[i][30:]
    card = GpuEngineFilter(pats, device=dev)
    assert card._sweep_tables is not None
    assert nfa_kernels.grouped_state_words(card._grouped) == 176
    assert card._long is not None and card._aug is None
    nfa_kernels.reset_launches()
    got = card.match_lines(lines)
    launches = dict(nfa_kernels.LAUNCHES)
    assert launches[nfa_kernels.GATED_SMEM] > 0
    assert launches[nfa_kernels.GROUPED_CHUNK_SMEM] > 0
    for name in (nfa_kernels.GATED, nfa_kernels.GATED_WIDE,
                 nfa_kernels.GROUPED, nfa_kernels.GROUPED_SMEM,
                 nfa_kernels.CHUNK):
        assert launches[name] == 0, name
    alt = re.compile(b"|".join(b"(?:" + p.encode() + b")" for p in pats))
    assert got == [alt.search(ln.rstrip(b"\n")) is not None for ln in lines]
    assert any(got[:2000]) and not all(got[:2000])
    assert any(got[-4:]) and not all(got[-4:])
    dp, live, acc = card._grouped, card._g_live, card._g_acc
    short = [ln.rstrip(b"\n")[:128] for ln in lines[:512]]
    rows = np.zeros((len(short), 128), dtype=np.uint8)
    for i, ln in enumerate(short):
        rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
    batch = torch.from_numpy(rows).to(dev)
    lens = torch.tensor([len(ln) for ln in short], dtype=torch.int32,
                        device=dev)
    cls = nfa.classify_chunk(dp, batch, lens, True, True)
    cls[7::50, 20] = dp.n_classes + 5
    cls[9::50, 30] = -1
    words = sweep.sweep_group_bits(card._sweep_tables, batch, lens)
    k3, _ = nfa_kernels.match_cls_grouped_gated(dp, live, acc, cls, words)
    assert torch.equal(k3, nfa_kernels.match_cls_grouped_gated_plain(
        dp, live, acc, cls, words))
    assert k3.any() and not k3.all()


SEQ_PATTERNS = ["needle", "^start", "end$", r"retry \d+/\d+"]


def seq_lines(n: int, lo: int, hi: int, seed: int) -> list:
    """Printable lines of lo..hi bytes, a needle in every other one."""
    rng = np.random.default_rng(seed)
    needles = [b"needle", b"retry 3/5"]
    out = []
    for i in range(n):
        size = int(rng.integers(lo, hi + 1))
        body = bytearray(rng.integers(32, 127, size=size, dtype=np.uint8))
        if i % 2:
            nd = needles[(i // 2) % 2]
            p = int(rng.integers(0, size - len(nd)))
            body[p:p + len(nd)] = nd
        out.append(bytes(body))
    out[0] = b"start" + out[0]
    return out + [out[1][:700] + b"end", b""]


@pytest.mark.parametrize("patterns,tile_t", [
    (SEQ_PATTERNS, 512), (PATTERNS + ["a" * 150 + "b"], 64),
], ids=["s128", "s256"])
def test_seqscan_tiles_on_card_equal_cpu(dev, patterns, tile_t):
    """``classify_line`` and ``tile_transfer_matrices`` (fp16 products on
    the card, float32 on the CPU) give the same int8 matrices."""
    from klogs_tpu_torch.ops import seqscan

    union = compile_patterns(patterns)
    progs = [nfa.pack_program(nfa.augment(union), device=d)
             for d in ("cpu", dev)]
    line = seq_lines(2, 5 * tile_t, 5 * tile_t, 1)[1]
    cls = [seqscan.classify_line(p, line, tile_t) for p in progs]
    assert torch.equal(cls[0], cls[1].cpu())
    tiles = cls[0].view(-1, tile_t)
    want = seqscan.tile_transfer_matrices(progs[0], tiles)
    got = seqscan.tile_transfer_matrices(progs[1], tiles.to(dev))
    assert got.device == dev and got.dtype == torch.int8
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) > tiles.shape[0]


def test_seqscan_lines_on_card_equal_cpu(dev):
    """``match_lines_scan`` on the card: enqueued without a host
    synchronisation, a bool tensor there, equal to the CPU's and the
    chunk kernel's verdicts; ``match_line_sharded`` over the card listed
    twice gives the same."""
    from klogs_tpu_torch.ops import seqscan

    union = compile_patterns(SEQ_PATTERNS)
    live, acc = union.n_states, union.n_states + 1
    progs = [nfa.pack_program(nfa.augment(union), device=d)
             for d in ("cpu", dev)]
    lines = seq_lines(6, 20_000, 40_000, 2)
    seqscan.match_lines_scan(progs[1], live, acc, lines)  # tables built
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # enqueued, never waited on
    try:
        got = seqscan.match_lines_scan(progs[1], live, acc, lines)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.device == dev and got.dtype == torch.bool
    want = seqscan.match_lines_scan(progs[0], live, acc, lines).tolist()
    assert got.tolist() == want
    assert want == GpuEngineFilter(SEQ_PATTERNS, device=dev).match_lines(lines)
    assert any(want) and not all(want)
    for i in (0, 1, 2):
        assert seqscan.match_line_sharded(progs[1], live, acc, lines[i],
                                          devices=[dev] * 2) is want[i]


def test_kernels_count_launches(dev):
    prog, live, acc = nfa.compile_grouped(PATTERNS, device=dev)
    nfa_kernels.reset_launches()
    nfa_kernels.match_cls_grouped(prog, live, acc, random_cls(prog, 8, 9, 0).to(dev))
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED] == 1
    nfa_kernels.match_cls_grouped_fused(prog, live, acc,
                                        random_cls(prog, 8, 9, 0).to(dev))
    assert nfa_kernels.LAUNCHES[nfa_kernels.FUSED] == 1
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED] == 1


# ---- K4: the fused-groups kernel -------------------------------------------


@pytest.mark.parametrize("patterns,needles", [
    W_CASES[4], W_CASES[8], W_CASES[16],
    (["q" * 600 + "z", "r" * 600 + "y", "panic:"],  # 640 states run at W =
     [b"q" * 600 + b"z", b"r" * 600 + b"y"]),  # 32, a group a block: 3 chunks
    W_CASES["wide"], (EXC_PATS, EXC_NEEDLES), (EDGE_PATS, EDGE_NEEDLES),
    (WIDE_CASES[48][0], [b"x12y", WIDE_CASES[48][2]]),
    (WIDE_CASES[132][0], [b"panic:", WIDE_CASES[132][2]]),
    (176, WIDE_CASES[176][1]),
], ids=["w4", "w8", "w16", "w32", "wide", "exceptions", "word_edge",
        "wide48", "wide132", "smem176"])
def test_fused_kernel_equals_plain_and_k1(dev, patterns, needles,
                                          monkeypatch):
    """K4 equals its plain version and K1 at each register width and
    past them (36, 48 and 132 words: ``grouped_fused_wide_kernel``; 176:
    ``grouped_fused_smem_kernel``), every launch counted under its
    route's name."""
    if isinstance(patterns, int):
        patterns = wide_case(patterns, monkeypatch)[0]
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    nfa_kernels.reset_launches()
    n = 0
    for cls in grouped_batches(prog, needles, dev):
        B = cls.shape[0]
        got = nfa_kernels.match_cls_grouped_fused(prog, live, acc, cls)
        n += 1
        exp = nfa_kernels.match_cls_grouped_fused_plain(prog, live, acc, cls)
        assert got.dtype == torch.bool and got.shape == (B,)
        assert torch.equal(got, exp)
        assert torch.equal(got, nfa_kernels.match_cls_grouped(prog, live, acc,
                                                              cls))
    name, others = route_names(nfa_kernels.kernel_states(prog.n_states) // 32,
                               "k4")
    assert nfa_kernels.LAUNCHES[name] == n
    assert not any(nfa_kernels.LAUNCHES[n] for n in others)


def test_fused_kernel_group_chunks_at_k1024(dev, monkeypatch):
    """156 groups: 10 chunks of 16, the last one ragged (12), walked in
    turn inside a block by K1 and spread over the grid by K4, over line
    counts that are not a multiple of a block's 32 lines; FakeCluster
    lines with minted needles, so some lines match."""
    from chip_smoke import make_patterns, minted_needle

    from klogs_tpu_torch.cluster.fake import synthetic_line

    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    prog, live, acc = nfa.compile_grouped(make_patterns(1024), device=dev)
    assert prog.follow.shape[0] == 156
    for B, width in ((1000, 128), (77, 256)):
        rows = np.zeros((B, width), dtype=np.uint8)
        lens = np.zeros(B, dtype=np.int32)
        for i in range(B):
            ln = synthetic_line(f"pod-{i:04d}", "c0", i, 1.7e9 + i).rstrip(b"\n")
            if i % 3 == 0:
                ln = ln[:30] + minted_needle(i * 7 % 1000) + ln[30:]
            ln = ln[:width]
            rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
            lens[i] = len(ln)
        cls = nfa.classify_chunk(prog, torch.from_numpy(rows).to(dev),
                                 torch.from_numpy(lens).to(dev), True, True)
        got = nfa_kernels.match_cls_grouped_fused(prog, live, acc, cls)
        assert torch.equal(got, nfa_kernels.match_cls_grouped_fused_plain(
            prog, live, acc, cls))
        assert torch.equal(got, nfa_kernels.match_cls_grouped(prog, live, acc,
                                                              cls))
        assert got.any() and not got.all()


def test_fused_engine_on_card_equals_cpu(dev, monkeypatch):
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "1")
    rng = np.random.default_rng(10)
    lines = [rng.integers(32, 127, size=int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 9000, size=300)]
    lines += [b"panic: now", b"start", b"the end", b"x" * 5000 + b"code=503"]
    nfa_kernels.reset_launches()
    gpu = GpuEngineFilter(PATTERNS, device=dev).match_lines(lines)
    assert nfa_kernels.LAUNCHES[nfa_kernels.FUSED] > 0
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED] == 0
    assert nfa_kernels.LAUNCHES[nfa_kernels.CHUNK] > 0
    assert gpu == GpuEngineFilter(PATTERNS, device="cpu").match_lines(lines)
    assert sum(gpu) >= 4


@pytest.mark.parametrize("env", [{}, {"KLOGS_TPU_SWEEP": "1"},
                                 {"KLOGS_TPU_PREFILTER": "1"}],
                         ids=["k1", "sweep", "prefilter"])
def test_engine_on_card_equals_cpu(dev, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(9)
    lines = [rng.integers(32, 127, size=int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 9000, size=300)]
    lines += [b"panic: now", b"start", b"the end", b"x" * 5000 + b"code=503",
              b"y" * (140 * 1024) + b"FATAL code=1"]
    nfa_kernels.reset_launches()
    gpu = GpuEngineFilter(PATTERNS, device=dev).match_lines(lines)
    assert (nfa_kernels.LAUNCHES[nfa_kernels.GATED] > 0) == bool(env)
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK_CLS] > 0
    cpu = GpuEngineFilter(PATTERNS, device="cpu").match_lines(lines)
    assert gpu == cpu
    assert sum(gpu) >= 5


@pytest.mark.parametrize("B,G,share", [
    (1, 3, 1.0), (45, 37, 0.3), (300, 64, 0.1), (700, 5, 0.0),
    (1000, 156, 0.02), (8192, 156, 0.05), (3000, 40, 1.0),
    (70000, 40, 0.1)])  # 274 slabs: a row of counts spans two scan pieces
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_gate_pairs_kernel_equals_plain(dev, B, G, share, dtype):
    """The card's pair list equals the plain one byte for byte (count,
    listed pairs, stats), over ragged line and group counts with stray
    bits at or past G, int32 and int64 words, empty and full gates, and
    more groups (rows of counts) than the scan has warps."""
    from klogs_tpu_torch.ops import bits

    rng = np.random.default_rng(B + G)
    words = bits.pack_bits(torch.from_numpy(rng.random((B, G)) < share))
    words[B // 3:B // 2] = 0  # a run of lines with no candidate
    if G % 32:
        words[::3, -1] |= (0xFFFFFFFF << (G % 32)) & 0xFFFFFFFF
    if dtype == torch.int32:
        words = bits.to_int32(words)
    nfa_kernels.reset_launches()
    pairs, n_pairs, stats = nfa_kernels.gate_pairs(words.to(dev), G)
    assert nfa_kernels.LAUNCHES[nfa_kernels.PAIRS] == 1
    exp_pairs, exp_n, exp_stats = nfa_kernels.gate_pairs(words, G)
    n = int(n_pairs)
    assert pairs.shape == exp_pairs.shape and n_pairs.dtype == torch.int32
    assert n == int(exp_n)
    assert torch.equal(pairs[:n].cpu(), exp_pairs[:n])
    assert torch.equal(stats.cpu(), exp_stats)


# K3 cases: W = 4, 8, 16, 32 (640 states padded to 1024) and past 32
# words (36, then WIDE_CASES' 40, 48 and 132: 2, 2, 2 and 5 words a
# lane of grouped_gated_wide_kernel), each with several groups.
GATED_CASES = [
    PATTERNS + [f"t{i:02d}lit" for i in range(40)],
    ["a" * 200 + "b", r"x\d+y"] + [f"lit{i:02d}x" for i in range(40)],
    ["b" * 400 + "c", "panic:"] + [f"v{i:02d}yz" for i in range(40)],
    ["q" * 600 + "z", "panic:"] + [f"u{i:02d}yz" for i in range(40)],
    ["q" * 1100 + "z", "panic:"] + [f"w{i:02d}yz" for i in range(40)],
    WIDE_CASES[40][0], WIDE_CASES[48][0], WIDE_CASES[132][0],
    *(words for words in SMEM_WORDS),  # past 160 words: wide_case's sets
]


@pytest.mark.parametrize("patterns", GATED_CASES,
                         ids=["w4", "w8", "w16", "w32", "wide", "wide40",
                              "wide48", "wide132",
                              *(f"smem{w}" for w in SMEM_WORDS)])
def test_gated_kernel_equals_plain(dev, patterns, monkeypatch):
    """K3 against its plain version under random gates: all ones, dense,
    sparse and empty, each over lines whose second half has no gate bit
    (a dead half); every launch counted under its route's name
    (``GATED_WIDE`` past 32 words, ``GATED_SMEM`` past 160)."""
    from klogs_tpu_torch.ops import bits

    if isinstance(patterns, int):
        patterns = wide_case(patterns, monkeypatch)[0]
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    G = int(prog.follow.shape[0])
    assert G > 1
    name, others = route_names(nfa_kernels.kernel_states(prog.n_states) // 32,
                               "k3")
    rng = np.random.default_rng(G)
    nfa_kernels.reset_launches()
    cases = ((1, 5, 1.0), (300, 67, 0.5), (1000, 131, 0.02), (700, 40, 0.0),
             (513, 99, 1.0))
    for B, T, share in cases:
        cls = random_cls(prog, B, T, B).to(dev)
        gate = torch.from_numpy(rng.random((B, G)) < share)
        if B > 1:
            gate[B // 2:] = False  # a dead half
        words = bits.pack_bits(gate).to(dev)
        got, stats = nfa_kernels.match_cls_grouped_gated(
            prog, live, acc, cls, words, want_stats=True)
        exp = nfa_kernels.match_cls_grouped_gated_plain(prog, live, acc,
                                                        cls, words)
        assert got.dtype == torch.bool and got.shape == (B,)
        assert torch.equal(got, exp)
        assert int(stats[0]) == int(gate.any(1).sum())
    assert nfa_kernels.LAUNCHES[name] == len(cases)
    assert not any(nfa_kernels.LAUNCHES[n] for n in others)


def test_gated_launch_alone_equals_wrapper(dev):
    """launch_gated on gate_pairs' list is the wrapper's verdict, lines
    off the list stay false; each launch_gated counts one launch and
    each list one builder launch."""
    from klogs_tpu_torch.ops import bits

    prog, live, acc = nfa.compile_grouped(PATTERNS, device=dev)
    G = int(prog.follow.shape[0])
    cls = random_cls(prog, 900, 50, 4).to(dev)
    gate = torch.from_numpy(np.random.default_rng(4).random((900, G)) < 0.1)
    words = bits.pack_bits(gate).to(dev)
    nfa_kernels.reset_launches()
    pairs, n_pairs, stats = nfa_kernels.gate_pairs(words, G)
    assert int(n_pairs) == int(gate.sum())
    assert int(stats[0]) == int(gate.any(1).sum())
    out = nfa_kernels.launch_gated(prog, live, acc, cls, pairs, n_pairs)
    got, _ = nfa_kernels.match_cls_grouped_gated(prog, live, acc, cls, words)
    assert torch.equal(out, got)
    assert not out[~gate.any(1).to(dev)].any()
    assert nfa_kernels.LAUNCHES[nfa_kernels.GATED] == 2
    assert nfa_kernels.LAUNCHES[nfa_kernels.PAIRS] == 2


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_gated_wrapper_does_not_wait_on_host(dev, dtype):
    """match_cls_grouped_gated (pair list, scan, kernel, stats) enqueues
    everything without a host synchronisation."""
    from klogs_tpu_torch.ops import bits

    prog, live, acc = nfa.compile_grouped(GATED_CASES[1], device=dev)
    G = int(prog.follow.shape[0])
    cls = random_cls(prog, 2000, 70, 5).to(dev)
    words = bits.pack_bits(torch.from_numpy(
        np.random.default_rng(5).random((2000, G)) < 0.2)).to(dev)
    if dtype == torch.int32:
        words = bits.to_int32(words)
    exp, _ = nfa_kernels.match_cls_grouped_gated(prog, live, acc, cls,
                                                 words)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, stats = nfa_kernels.match_cls_grouped_gated(
            prog, live, acc, cls, words, want_stats=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, exp)
    assert torch.equal(got, nfa_kernels.match_cls_grouped_gated_plain(
        prog, live, acc, cls, words))


def test_gated_wide_wrapper_does_not_wait_on_host(dev):
    """As above past 32 words (the watch-list set: 36 words,
    ``grouped_gated_wide_kernel``)."""
    from klogs_tpu_torch.ops import bits

    patterns, needles, _ = wide_case(36)
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    G = int(prog.follow.shape[0])
    cls = text_cls(prog, 2000, 61, needles, 6, dev)
    words = bits.pack_bits(torch.from_numpy(
        np.random.default_rng(6).random((2000, G)) < 0.3)).to(dev)
    exp, _ = nfa_kernels.match_cls_grouped_gated(prog, live, acc, cls,
                                                 words)  # warm-up
    torch.cuda.synchronize()
    nfa_kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, stats = nfa_kernels.match_cls_grouped_gated(
            prog, live, acc, cls, words, want_stats=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert nfa_kernels.LAUNCHES[nfa_kernels.GATED_WIDE] == 1
    assert torch.equal(got, exp)
    assert torch.equal(got, nfa_kernels.match_cls_grouped_gated_plain(
        prog, live, acc, cls, words))
    assert got.any()


@pytest.mark.parametrize("words", [36, 132, *SMEM_WORDS])
def test_gated_wide_kernel_all_ones_equals_k1(dev, words, monkeypatch):
    """Past 32 words, K3 under an all-ones gate is K1's wide kernel (past
    160 words, the shared-memory kernels of both)."""
    from klogs_tpu_torch.ops import bits

    patterns, needles, dense = wide_case(words, monkeypatch)
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    rows, lens = wide_rows(600, len(dense) + 40, needles, dense, words)
    cls = nfa.classify_chunk(prog, torch.from_numpy(rows).to(dev),
                             torch.from_numpy(lens).to(dev), True, True)
    ones = bits.pack_bits(torch.ones((600, prog.follow.shape[0]),
                                     dtype=torch.bool)).to(dev)
    nfa_kernels.reset_launches()
    got, _ = nfa_kernels.match_cls_grouped_gated(prog, live, acc, cls, ones)
    k1 = nfa_kernels.match_cls_grouped(prog, live, acc, cls)
    assert torch.equal(got, k1)
    assert got[0] and not got[1] and not got.all()
    k3, others = route_names(words, "k3")
    assert nfa_kernels.LAUNCHES[k3] == 1
    assert nfa_kernels.LAUNCHES[route_names(words, "k1")[0]] == 1
    assert not any(nfa_kernels.LAUNCHES[n] for n in others)


def test_gated_kernel_all_ones_equals_k1(dev):
    from klogs_tpu_torch.ops import bits

    prog, live, acc = nfa.compile_grouped(PATTERNS, device=dev)
    cls = random_cls(prog, 2000, 70, 3).to(dev)
    ones = bits.pack_bits(torch.ones((2000, prog.follow.shape[0]),
                                     dtype=torch.bool)).to(dev)
    nfa_kernels.reset_launches()
    got, _ = nfa_kernels.match_cls_grouped_gated(prog, live, acc, cls, ones)
    assert torch.equal(got, nfa_kernels.match_cls_grouped(prog, live, acc,
                                                          cls))
    assert nfa_kernels.LAUNCHES[nfa_kernels.GATED] == 1


@pytest.mark.parametrize("env", [{}, {"KLOGS_TPU_SWEEP": "1"},
                                 {"KLOGS_TPU_PREFILTER": "1"},
                                 {"KLOGS_TPU_FUSED_GROUPS": "1"}],
                         ids=["k1", "sweep", "prefilter", "fused"])
def test_dispatch_does_not_wait_on_host(dev, env, monkeypatch):
    """Dispatch enqueues the classify, the gate, the kernel and the
    copies back (verdicts and gate stats) without a host synchronisation;
    only fetch waits, on its event. The fused kernel has no gate."""
    from klogs_tpu_torch.filters.base import FilterStats, frame_lines

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    stats = FilterStats()
    eng = GpuEngineFilter(PATTERNS, device=dev, stats=stats)
    lines = [b"panic: x", b"x code=503", b"nothing here", b"q" * 300] * 100
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    exp = eng.fetch_framed(eng.dispatch_framed(payload, offsets))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = eng.dispatch_framed(payload, offsets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eng.fetch_framed(handle).tolist() == exp.tolist()
    assert exp.sum() == 200
    gated = bool(env) and "KLOGS_TPU_FUSED_GROUPS" not in env
    assert stats.pf_lines == (2 * len(lines) if gated else 0)


def _syncs(fn) -> int:
    """Host synchronisations ``fn`` makes, counted by torch's sync debug
    mode (each one warns)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("env", [{}, {"KLOGS_TPU_SWEEP": "1"},
                                 {"KLOGS_TPU_FUSED_GROUPS": "1"}],
                         ids=["k1", "sweep", "fused"])
def test_traced_dispatch_adds_no_sync(dev, env, monkeypatch):
    """With every trace sampled and the profiler folding, the engine's
    dispatch (its device.frame and device.kernel spans and sub-batch
    records, a long line's chunk launches too) waits on the host no more
    often than untraced, and its verdicts equal the untraced batch's."""
    from klogs_tpu_torch import obs
    from klogs_tpu_torch.filters.base import FilterStats, frame_lines
    from klogs_tpu_torch.obs import profiler, trace

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    stats = FilterStats(registry=obs.Registry())
    eng = GpuEngineFilter(PATTERNS, device=dev, stats=stats)
    lines = ([b"panic: x", b"x code=503", b"nothing here", b"q" * 300] * 100
             + [b"y" * 5000 + b" disk is full"])
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    off = eng.fetch_framed(eng.dispatch_framed(payload, offsets))  # warm-up
    handles = {}
    n_off = _syncs(lambda: handles.update(
        off=eng.dispatch_framed(payload, offsets)))
    trace.reset(1.0)
    profiler.PROFILER.enable(1.0)
    try:
        with trace.TRACER.span("coalescer.dispatch"):
            n_on = _syncs(lambda: handles.update(
                on=eng.dispatch_framed(payload, offsets)))
        spans = {d["name"] for d in trace.TRACER.finished_spans()}
    finally:
        profiler.PROFILER.reset()
        trace.reset(None)
    assert n_on <= n_off
    assert {"device.frame", "device.kernel"} <= spans
    on = eng.fetch_framed(handles["on"])
    assert on.tolist() == eng.fetch_framed(handles["off"]).tolist() \
        == off.tolist()
    assert on.sum() == 201
    assert stats.registry.family("klogs_engine_bucket_width_bytes").count > 0


# ---- the ragged pack ---------------------------------------------------------

PACK_CHUNK = 4096
# The packer's edge cases: raw lines, newlines kept in the payload.
PACK_CASES = {
    "zero_length": [b"", b"", b"abc\n", b"", b"x"],
    "only_newlines": [b"\n", b"\n\n\n", b"x\n", b"\n", b"\n\n"],
    "trailing_runs": [b"panic: a\n\n\n", b"d\n", b"end\n\n",
                      b"z" * 127 + b"\n\n", b"y" * 300 + b"\n\n\n\n"],
    "exact_widths": [b"a" * w + b"\n" * (w % 3) for w in
                     (127, 128, 129, 255, 256, 257, 4095, 4096)],
    "exact_chunks": [b"b" * (k * PACK_CHUNK) + b"\n" * (k % 2)
                     for k in (1, 2, 3)]
    + [b"c" * (2 * PACK_CHUNK + 1), b"d" * (PACK_CHUNK + 1) + b"\n"],
    "no_final_newline": [b"a\n", b"bb\n", b"code=503 " * 40 + b"\n", b"ccc"],
    "random": [np.random.default_rng(i).integers(
        0, 256, size=int(n), dtype=np.uint8).tobytes()
        for i, n in enumerate(np.random.default_rng(7).integers(
            0, 3 * PACK_CHUNK, size=300))],
}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_kernel_equals_plain(dev, case):
    """pack_rows on the card equals its plain version byte for byte:
    every line at widths 128, 256, 300 (not a multiple of 4) and 4096,
    at its count of rows and at many more, an empty bucket, and chunk
    k of every line at skip = k * 4096."""
    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.filters.gpu import strip_newlines

    payload, offsets, _ = frame_lines(PACK_CASES[case], strip_nl=False)
    s, e = strip_newlines(payload, offsets)
    host = torch.from_numpy(np.frombuffer(payload + b"\0",
                                          dtype=np.uint8).copy())[:-1]
    starts, lens = torch.from_numpy(s), torch.from_numpy(e - s)
    on = (host.to(dev), starts.to(dev), lens.to(dev))
    n = len(starts)
    nfa_kernels.reset_launches()
    calls = 0
    for width in (128, 256, 300, 4096):
        for rows in (n, n + 37):
            got = pack.pack_rows(*on, width, rows)
            assert torch.equal(got.cpu(), pack.pack_rows_plain(
                host, starts, lens, width, rows))
            calls += 1
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    assert not pack.pack_rows(on[0], none, none, 128, 8).any()
    for k in range(-(-int(lens.max()) // PACK_CHUNK) + 1):
        got = pack.pack_rows(*on, PACK_CHUNK, n + 3, skip=k * PACK_CHUNK)
        assert torch.equal(got.cpu(), pack.pack_rows_plain(
            host, starts, lens, PACK_CHUNK, n + 3, skip=k * PACK_CHUNK))
        calls += 1
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK] == calls + 1


def test_pack_kernel_large_offsets(dev):
    """Starts past 2**31 - 4096 of a payload: the kernel's offsets are
    64-bit through starts + skip."""
    size = 2**31 + 2 * PACK_CHUNK
    payload = torch.zeros(size, dtype=torch.uint8, device=dev)
    tail = torch.arange(3 * PACK_CHUNK, device=dev) % 251
    payload[-3 * PACK_CHUNK:] = tail.to(torch.uint8)
    starts = torch.tensor([size - 3 * PACK_CHUNK, size - 5], device=dev)
    lens = torch.tensor([3 * PACK_CHUNK, 5], device=dev)
    for k in range(3):
        got = pack.pack_rows(payload, starts, lens, PACK_CHUNK, 8,
                             skip=k * PACK_CHUNK)
        assert torch.equal(got[0], tail[k * PACK_CHUNK:(k + 1) * PACK_CHUNK]
                           .to(torch.uint8))
        short = torch.zeros(PACK_CHUNK, dtype=torch.uint8, device=dev)
        if k == 0:
            short[:5] = payload[-5:]
        assert torch.equal(got[1], short)
        assert not got[2:].any()


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_classify_kernel_equals_plain(dev, case):
    """pack_classify_rows on the card equals its plain version element
    for element (class ids, stripped lengths, byte rows), in both of the
    kernel's schedules (staged, rows up to 1024 bytes; flat, wider): every
    line on raw lengths at widths 1, 128, 256, 300 (not a multiple of
    16), 4096 and 12000, at its count of rows and at many more, with and
    without the BEGIN and latch columns; an empty bucket; and chunk k of
    every line at skip = k * 4096 through the long lines' program, first
    and final as the engine sets them."""
    from klogs_tpu_torch.filters.base import frame_lines

    prog, _, _ = nfa.compile_grouped(PATTERNS, device=dev)
    aug = nfa.pack_program(nfa.augment(compile_patterns(PATTERNS)),
                           device=dev)
    payload, offsets, _ = frame_lines(PACK_CASES[case], strip_nl=False)
    offsets = np.asarray(offsets, dtype=np.int64)
    pt = torch.from_numpy(np.frombuffer(payload + b"\0",
                                        dtype=np.uint8).copy())[:-1].to(dev)
    starts = torch.from_numpy(offsets[:-1].copy()).to(dev)
    lens = torch.from_numpy(np.diff(offsets)).to(dev)
    n = len(starts)
    nfa_kernels.reset_launches()
    calls = 0

    def same(*args):
        exp = pack.pack_classify_rows_plain(*args)
        for got in (pack.pack_classify_rows(*args),
                    pack._launch_classify(*args, flat=True)):
            for g, e in zip(got, exp):
                assert (g is None and e is None) or torch.equal(g, e), \
                    args[3:]

    for width in (1, 128, 256, 300, 4096, 12000):
        for rows in (n, n + 37):
            for first, final, want in ((True, True, True),
                                       (False, False, False),
                                       (True, False, True)):
                same(pt, starts, lens, width, rows, prog, 0, first, final,
                     want)
                calls += 1
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    same(pt, none, none, 128, 8, prog)
    calls += 1
    n_chunks = -(-int(lens.max()) // PACK_CHUNK) + 1
    for k in range(n_chunks):
        same(pt, starts, lens, PACK_CHUNK, n + 3, aug, k * PACK_CHUNK,
             k == 0, k == n_chunks - 1)
        calls += 1
    torch.cuda.synchronize()
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK_CLS] == 2 * calls


def test_pack_classify_kernel_large_offsets(dev):
    """Starts past 2**31 - 4096 of a payload: the fused kernel's offsets
    are 64-bit through starts + skip; lines end in newline runs."""
    size = 2**31 + 2 * PACK_CHUNK
    prog, _, _ = nfa.compile_grouped(PATTERNS, device=dev)
    payload = torch.zeros(size, dtype=torch.uint8, device=dev)
    tail = torch.arange(3 * PACK_CHUNK, device=dev) % 251
    payload[-3 * PACK_CHUNK:] = tail.to(torch.uint8)
    payload[-3] = payload[-2] = payload[-1] = 0x0A
    starts = torch.tensor([size - 3 * PACK_CHUNK, size - 9, size - 2],
                          device=dev)
    lens = torch.tensor([3 * PACK_CHUNK, 9, 2], device=dev)
    for k in range(3):
        args = (payload, starts, lens, PACK_CHUNK, 8, prog, k * PACK_CHUNK,
                k == 0, k == 2, True)
        got = pack.pack_classify_rows(*args)
        exp = pack.pack_classify_rows_plain(*args)
        for g, e in zip(got, exp):
            assert torch.equal(g, e)
        assert got[1][:3].tolist() == [3 * PACK_CHUNK - 3, 6, 0]
        if k == 0:
            assert torch.equal(got[2][1, :6], payload[-9:-3])


def test_async_service_many_batches_in_flight(dev):
    """48 distinct framed batches through AsyncFilterService, each its own
    dispatch (coalesce_lines at 1), up to 16 in flight, each with long
    lines that keep the card busy while later batches are staged: the
    verdicts equal the CPU engine's, so no pinned staging buffer was
    rewritten under a copy still in flight."""
    import asyncio

    from klogs_tpu_torch.filters import async_service
    from klogs_tpu_torch.filters.base import frame_lines

    rng = np.random.default_rng(12)
    needles = [b"panic: x", b"retry 3/5", b"code=503", b"FATAL a code=9",
               b"disk is full", b"start", b"end"]
    batches = []
    for b in range(48):
        lines = []
        for i, n in enumerate(rng.integers(0, 700, size=200)):
            body = bytearray(rng.integers(32, 127, size=int(n),
                                          dtype=np.uint8))
            if (i + b) % 5 == 0 and n > 20:
                nd = needles[(i + b) % len(needles)]
                p = int(rng.integers(0, n - len(nd)))
                body[p:p + len(nd)] = nd
            lines.append(bytes(body) + b"\n")
        lines += [bytes(rng.integers(32, 127, size=int(n), dtype=np.uint8))
                  + (b"code=504" if b % 2 else b"") + b"\n"
                  for n in rng.integers(5000, 40000, size=4)]
        batches.append(frame_lines(lines, strip_nl=False)[:2])
    svc = async_service.AsyncFilterService(
        GpuEngineFilter(PATTERNS, device=dev), coalesce_lines=1)

    async def go():
        res = await asyncio.gather(*[svc.match_framed(p, o)
                                     for p, o in batches])
        await svc.aclose()
        return res

    nfa_kernels.reset_launches()
    got = asyncio.run(go())
    assert svc.batches_dispatched == len(batches)
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK_CLS] >= 2 * len(batches)
    cpu = GpuEngineFilter(PATTERNS, device="cpu")
    for (p, o), g in zip(batches, got):
        assert g.tolist() == cpu.fetch_framed(cpu.dispatch_framed(p, o)) \
            .tolist()
    assert sum(int(g.sum()) for g in got) > 48


# ---- follow mode on the card -------------------------------------------

FOLLOW_CLOCK = 1_753_800_000.0


def _emitted(fc, pod: str, n_hist: int) -> bytes:
    """Every line pod's c0 stream sent: its history, then the lines it
    generated (the fixed clock makes them regenerable from next_seq)."""
    from klogs_tpu_torch.cluster.fake import synthetic_line

    c = fc.namespaces["default"][pod].containers["c0"]
    return b"".join([ln for _, ln in c.lines] + [
        synthetic_line(pod, "c0", s, FOLLOW_CLOCK)
        for s in range(n_hist, c.next_seq)])


def _follow_on(dev, out_dir, n_pods: int, interval: float, stop_after,
               match: list, watch=None):
    """``app.run_async`` in follow mode over a fixed-clock FakeCluster,
    stopped by ``stop`` after ``stop_after`` s (``watch(fc)`` runs beside
    it); returns (rc, fc, stats)."""
    import asyncio

    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster
    from klogs_tpu_torch.filters import sink as sink_mod
    from klogs_tpu_torch.ui import term

    fc = FakeCluster.synthetic(n_pods=n_pods, lines_per_container=40,
                               clock=lambda: FOLLOW_CLOCK,
                               follow_interval_s=interval)
    argv = ["-n", "default", "-a", "-f", "-p", str(out_dir)]
    for m in match:
        argv += ["--match", m]
    made = []
    real = sink_mod.make_pipeline

    def recording(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    async def go():
        stop = asyncio.Event()

        async def stopper():
            if watch is not None:
                await watch(fc)
            await asyncio.sleep(stop_after)
            stop.set()

        t = asyncio.create_task(stopper())
        try:
            return await app.run_async(cli.parse_args(argv), backend=fc,
                                       stop=stop, device=dev)
        finally:
            t.cancel()

    term.set_ui_stream(open(os.devnull, "w"))
    sink_mod.make_pipeline = recording
    try:
        rc = asyncio.run(go())
    finally:
        sink_mod.make_pipeline = real
        term.set_ui_stream(None)
    return rc, fc, made[0].stats


def test_follow_deadline_flusher_on_card(dev, tmp_path):
    """A follow run on the card: the needle a quiet stream sends (its
    next line comes 1 s later) lands in its file within 4 x deadline_s
    of its emission through the deadline flusher, and every file equals
    the CPU engine's filter over exactly the lines its stream sent."""
    import asyncio
    import re
    import time

    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.filters.sink import DEADLINE_S

    latencies = []

    async def watch(fc):
        c = fc.namespaces["default"]["pod-0000"].containers["c0"]
        path = os.path.join(str(tmp_path / "card"), "pod-0000__c0.log")
        for seq in (41, 42, 43):
            while c.next_seq <= seq:
                await asyncio.sleep(0.001)
            t0 = time.perf_counter()
            needle = f" seq={seq} ".encode()
            while True:
                with open(path, "rb") as f:
                    if needle in f.read():
                        break
                await asyncio.sleep(0.001)
            latencies.append(time.perf_counter() - t0)

    match = [r"ERROR", r"seq=4[1-3] "]
    rc, fc, stats = _follow_on(dev, tmp_path / "card", 8, 1.0, 0.2, match,
                               watch=watch)
    assert rc == 0
    assert len(latencies) == 3 and max(latencies) < 4 * DEADLINE_S, latencies
    assert stats.deadline_flushes > 0
    cpu = GpuEngineFilter(match, device="cpu")
    rx = re.compile("|".join(match).encode())
    for pod in sorted(fc.namespaces["default"]):
        sent = _emitted(fc, pod, 40).splitlines(keepends=True)
        v = cpu.fetch_framed(cpu.dispatch_framed(
            *frame_lines(sent, strip_nl=False)[:2]))
        exp = b"".join(ln for ln, k in zip(sent, v) if k)
        assert exp == b"".join(ln for ln in sent if rx.search(ln))
        with open(tmp_path / "card" / f"{pod}__c0.log", "rb") as f:
            assert f.read() == exp, pod


def test_follow_stop_with_batches_in_flight(dev, tmp_path):
    """Fast streams, stop fired while device batches are in flight: each
    file holds exactly the matching lines its stream sent, none lost or
    written twice."""
    import re

    match = ["ERROR.*code=[45]00", "seq=[0-9]*7 ", "latency=49"]
    nfa_kernels.reset_launches()
    rc, fc, stats = _follow_on(dev, tmp_path, 64, 0.001, 1.5, match)
    assert rc == 0
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED] > 0
    rx = re.compile("|".join(match).encode())
    total = 0
    for pod in sorted(fc.namespaces["default"]):
        sent = _emitted(fc, pod, 40)
        total += sent.count(b"\n")
        exp = b"".join(ln for ln in sent.splitlines(keepends=True)
                       if rx.search(ln))
        with open(tmp_path / f"{pod}__c0.log", "rb") as f:
            assert f.read() == exp, pod
    assert stats.lines_in == total > 64 * 100


def test_engine_small_batches_launch_kernels(dev):
    """Follow mode's batches of 1 to 8 lines (one batch bucket of 8 rows)
    run the kernels, not their plain versions: each launches K1 and
    pack_classify_rows once, and a long line K2 (and pack_classify_rows a
    chunk), with the CPU engine's verdicts."""
    from klogs_tpu_torch.filters.base import frame_lines

    card = GpuEngineFilter(PATTERNS, device=dev)
    cpu = GpuEngineFilter(PATTERNS, device="cpu")
    lines = [b"panic: now\n", b"quiet\n", b"retry 3/5 end\n", b"start x\n",
             b"x" * 6000 + b" code=503\n", b"disk is full\n", b"a\n", b"\n"]
    for n in range(1, 9):
        frame = frame_lines(lines[:n], strip_nl=False)[:2]
        nfa_kernels.reset_launches()
        got = card.fetch_framed(card.dispatch_framed(*frame))
        long_ = n >= 5
        assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED] == 1
        assert nfa_kernels.LAUNCHES[nfa_kernels.PACK_CLS] == 1 + 2 * long_
        assert nfa_kernels.LAUNCHES[nfa_kernels.CHUNK] == 2 * long_
        assert got.tolist() == cpu.fetch_framed(
            cpu.dispatch_framed(*frame)).tolist()


def test_backfill_on_card_equals_cpu(dev, tmp_path, monkeypatch):
    """``--backfill`` of two rotated sets (gzip and plain, short lines
    and lines over 4 KiB) through ``app.run_async`` on the card writes
    the files the same run writes on device "cpu"; every dispatch after
    the first runs under ``set_sync_debug_mode("error")``, and K1, K2
    and pack_rows launch."""
    import asyncio
    import gzip
    import re

    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.ui import term

    rng = np.random.default_rng(11)
    arch = tmp_path / "arch"
    arch.mkdir()
    words = [b"panic: x", b"retry 3/5", b"code=503", b"fine", b"calm line"]
    for k, gz in ((0, True), (1, False)):
        lines = [b"set%d seq=%06d " % (k, i) + words[i % 5] + b" "
                 + b"p" * int(rng.integers(0, 60)) + b"\n"
                 for i in range(40000)]
        for j in (100, 20000, 39000):
            lines[j] = bytes(rng.integers(97, 123, size=4000 + 3000 * (j % 7),
                                          dtype=np.uint8)) + b" code=504\n"
        third = len(lines) // 3
        gens = [b"".join(lines[:third]), b"".join(lines[third:2 * third]),
                b"".join(lines[2 * third:])]
        for g, ext in ((0, ".2"), (1, ".1")):
            if gz:
                (arch / f"app{k}.log{ext}.gz").write_bytes(
                    gzip.compress(gens[g], 1))
            else:
                (arch / f"app{k}.log{ext}").write_bytes(gens[g])
        (arch / f"app{k}.log").write_bytes(gens[2])

    dispatches = [0]
    real = GpuEngineFilter.dispatch_framed

    def strict(self, *a, **kw):
        dispatches[0] += 1
        if dispatches[0] == 1 or self.device.type != "cuda":
            return real(self, *a, **kw)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(GpuEngineFilter, "dispatch_framed", strict)
    match = PATTERNS[:3]
    outs = {}
    term.set_ui_stream(open(os.devnull, "w"))
    try:
        for name, device in (("card", dev), ("cpu", "cpu")):
            argv = ["--backfill", str(arch), "-p", str(tmp_path / name)]
            for p in match:
                argv += ["--match", p]
            nfa_kernels.reset_launches()
            assert asyncio.run(app.run_async(cli.parse_args(argv),
                                             device=device)) == 0
            if name == "card":
                launches = dict(nfa_kernels.LAUNCHES)
            outs[name] = {f: (tmp_path / name / f).read_bytes()
                          for f in sorted(os.listdir(tmp_path / name))}
    finally:
        term.set_ui_stream(None)
    assert outs["card"] == outs["cpu"] and len(outs["card"]) == 2
    rx = re.compile("|".join(match).encode())
    for body in outs["card"].values():
        assert body and all(rx.search(ln) for ln in body.splitlines())
    assert dispatches[0] > 2
    for k in (nfa_kernels.GROUPED, nfa_kernels.CHUNK, nfa_kernels.PACK_CLS):
        assert launches[k] > 0, launches


# ---- filterd on the card -----------------------------------------------

def test_filterd_on_card_serves_two_clients_the_cpu_verdicts(dev):
    """The port's filterd on the card (kernels built before it binds)
    serving two concurrent clients framed batches of short and long
    lines: each client's verdicts equal the CPU engine's on its frames,
    and the server's engine launched K1, K2 and pack_rows."""
    import asyncio

    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.service.client import RemoteFilterClient
    from klogs_tpu_torch.service.server import FilterServer

    rng = np.random.default_rng(21)
    needles = [b"panic: x", b"retry 3/5", b"code=503", b"FATAL a code=9",
               b"disk is full"]
    frames = []
    for c in range(2):
        for b in range(6):
            lines = []
            for i, n in enumerate(rng.integers(0, 600, size=3000)):
                body = bytearray(rng.integers(32, 127, size=int(n),
                                              dtype=np.uint8))
                if (i + b + c) % 7 == 0 and n > 20:
                    nd = needles[(i + b) % len(needles)]
                    p = int(rng.integers(0, n - len(nd)))
                    body[p:p + len(nd)] = nd
                lines.append(bytes(body) + b"\n")
            lines += [bytes(rng.integers(32, 127, size=int(n),
                                         dtype=np.uint8))
                      + (b"code=504" if b % 2 else b"") + b"\n"
                      for n in rng.integers(5000, 30000, size=3)]
            frames.append((c, frame_lines(lines, strip_nl=False)[:2]))

    async def go():
        server = FilterServer(PATTERNS, port=0, device=dev)
        port = await server.start()
        clients = [RemoteFilterClient(f"127.0.0.1:{port}") for _ in range(2)]
        try:
            for cl in clients:
                await cl.verify_patterns(PATTERNS)
            nfa_kernels.reset_launches()
            got = await asyncio.gather(*[clients[c].match_framed(p, o)
                                         for c, (p, o) in frames])
            return got, dict(nfa_kernels.LAUNCHES)
        finally:
            for cl in clients:
                await cl.aclose()
            await server.stop()

    got, launches = asyncio.run(go())
    cpu = GpuEngineFilter(PATTERNS, device="cpu")
    for (_, (p, o)), g in zip(frames, got):
        assert g.tolist() == cpu.fetch_framed(cpu.dispatch_framed(p, o)) \
            .tolist()
    assert sum(int(g.sum()) for g in got) > 100
    for k in (nfa_kernels.GROUPED, nfa_kernels.CHUNK, nfa_kernels.PACK_CLS):
        assert launches[k] > 0, launches


def test_fleet_and_multi_set_filterd_on_card(dev):
    """A two-filterd fleet on the card behind one ShardedFilterClient
    (round-robin: both serve), and a multi-set filterd on the card with
    two registered sets (one of 7 patterns, one of 72, which the sweep
    gates): every verdict equals the CPU engine's for the batch's own
    set; evicting the 72-pattern set gives its device memory back (the
    allocated bytes within 5% of their level before it registered)."""
    import asyncio
    import gc

    from klogs_tpu_torch import obs
    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.service.client import RemoteFilterClient
    from klogs_tpu_torch.service.server import FilterServer
    from klogs_tpu_torch.service.shard import ShardedFilterClient

    big = PATTERNS + [f"svc{i:02d}-(?:timeout|refused) \\d+"
                      for i in range(65)]
    rng = np.random.default_rng(31)
    frames = []
    for b in range(8):
        lines = []
        for i, n in enumerate(rng.integers(0, 300, size=2000)):
            body = bytearray(rng.integers(32, 127, size=int(n),
                                          dtype=np.uint8))
            if (i + b) % 5 == 0 and n > 30:
                nd = [b"panic: x", b"code=503", b"svc07-refused 12",
                      b"svc41-timeout 3"][(i + b) % 4]
                p = int(rng.integers(0, n - len(nd)))
                body[p:p + len(nd)] = nd
            lines.append(bytes(body) + b"\n")
        frames.append(frame_lines(lines, strip_nl=False)[:2])

    async def fleet():
        servers = [FilterServer(PATTERNS, port=0, device=dev)
                   for _ in range(2)]
        ports = [await s.start() for s in servers]
        reg = obs.Registry()
        obs.register_all(reg)
        sc = ShardedFilterClient([f"127.0.0.1:{p}" for p in ports],
                                 hedge_s=None, registry=reg)
        try:
            await sc.verify_patterns(PATTERNS)
            got = [await sc.match_framed(p, o) for p, o in frames]
            fam = reg.family("klogs_shard_batches_total")
            return got, [c.value for _, c in fam.children()]
        finally:
            await sc.aclose()
            for s in servers:
                await s.stop()

    async def multi():
        server = FilterServer([], port=0, device=dev, multi_set=True)
        port = await server.start()
        small = RemoteFilterClient(f"127.0.0.1:{port}")
        large = RemoteFilterClient(f"127.0.0.1:{port}")
        try:
            await small.verify_patterns(PATTERNS)
            # A first batch builds the small set's cached bit tables.
            await small.match_framed(*frames[1])
            torch.cuda.synchronize()
            gc.collect()
            before = torch.cuda.memory_allocated(dev)
            await large.verify_patterns(big)
            got = await asyncio.gather(
                *[(small if i % 2 else large).match_framed(p, o)
                  for i, (p, o) in enumerate(frames)])
            sweep = server.device_sweep
            assert await server.tenants.evict(large._set_id, "idle")
            gc.collect()
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated(dev)
            return got, sweep, before, after
        finally:
            await small.aclose()
            await large.aclose()
            await server.stop()

    with_sweep = os.environ.get("KLOGS_TPU_SWEEP")
    os.environ["KLOGS_TPU_SWEEP"] = "1"
    try:
        got_fleet, wins = asyncio.run(fleet())
        got_multi, sweep, before, after = asyncio.run(multi())
        cpu = {len(p): GpuEngineFilter(p, device="cpu")
               for p in (PATTERNS, big)}
    finally:
        if with_sweep is None:
            os.environ.pop("KLOGS_TPU_SWEEP")
        else:
            os.environ["KLOGS_TPU_SWEEP"] = with_sweep
    small_cpu, big_cpu = cpu[len(PATTERNS)], cpu[len(big)]
    for (p, o), g in zip(frames, got_fleet):
        assert g.tolist() == small_cpu.fetch_framed(
            small_cpu.dispatch_framed(p, o)).tolist()
    assert sorted(wins) == [4, 4]
    for i, ((p, o), g) in enumerate(zip(frames, got_multi)):
        eng = small_cpu if i % 2 else big_cpu
        assert g.tolist() == eng.fetch_framed(
            eng.dispatch_framed(p, o)).tolist()
    assert sweep
    assert after <= before * 1.05, (before, after)


# ---- the operating-point controller and the host C ----------------------

def test_tune_auto_controller_on_the_card(dev):
    """``chip_smoke.py``'s ``tune_auto`` (a) at a smaller size: from 4 in
    flight under 128 callers of 4000-line frames for 3 s, the
    ``KLOGS_TUNE=auto`` controller steps the depth up, every value in
    its bounds, every verdict equal to a fixed-flag engine's; idle, it
    steps back down, and the service closes with every permit back."""
    import chip_smoke as cs
    from klogs_tpu_torch.cluster.fake import FakeCluster
    from klogs_tpu_torch.filters.base import FilterStats, frame_lines
    from klogs_tpu_torch.ops import tune

    res = cs.tune_auto_service(torch, np, nfa_kernels, tune, FakeCluster,
                               GpuEngineFilter, FilterStats, frame_lines,
                               dev, seconds=3.0, n_callers=128)
    assert res["ok"], res
    assert res["max_in_flight_ups"] >= 1 and res["wrong"] == 0


def test_native_functions_equal_their_plain_versions(dev):
    """``chip_smoke.py``'s ``native`` phase at a smaller size, on the
    card machine's own build of ``native/_hostops.c``: each C function
    byte for byte its plain version over FakeCluster streams cut in 4 KiB
    chunks, one carrying a 180 KiB line."""
    import chip_smoke as cs
    from klogs_tpu_torch.cluster.fake import FakeCluster

    res = cs.native_phase(np, FakeCluster, n_streams=64,
                          lines_per_stream=200)
    assert not any(f["mismatches"] for f in res["functions"].values())
    assert res["chunks_ending_mid_line"] and res["chunks_inside_the_long_line"]


def _literal_families(k: int) -> list:
    fam = [lambda i: f"svc-{i:04d} unreachable", lambda i: rf"errcode={i:05d}\b",
           lambda i: rf"CRIT{i:05d}", lambda i: f"user=u{i:06d} denied"]
    return [r"ERROR \d+", "timed out"] + [fam[i % 4](i) for i in range(k - 2)]


def _family_lines(k: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    hits = [f"svc-{i:04d} unreachable" for i in range(0, k + 40, 4)] + [
        "ERROR 5", "timed out", "CRIT00013"]
    out = []
    for j in range(n):
        body = rng.integers(32, 127, size=int(rng.integers(0, 200)),
                            dtype=np.uint8).tobytes()
        if j % 9 == 0:
            body += hits[int(rng.integers(0, len(hits)))].encode()
        out.append(body + b"\n")
    return out


def test_indexed_device_sweep_on_card_equals_host(dev, tmp_path, monkeypatch):
    """IndexedFilter(sweep="device") on the card: its candidate matrix
    equals its index's host sweep bit for bit, its verdicts the host
    sweep filter's, through pack_rows (counted) and the torch sweep; a
    slab with a line past 4096 bytes sweeps on the host."""
    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.filters.indexed import IndexedFilter

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    pats = _literal_families(256)
    d = IndexedFilter(pats, sweep="device", device=dev)
    h = IndexedFilter(pats, sweep="host")
    assert d._sweep_path == "device"
    frames = [frame_lines(_family_lines(256, 5000, s))[:2] for s in (1, 2)]
    frames.append(frame_lines(_family_lines(256, 50, 3)
                              + [b"y" * 6000 + b"ERROR 1\n"])[:2])
    for payload, off in frames[:2]:
        assert np.array_equal(d._device_candidates(payload, off),
                              d.index.group_candidates(payload, off))
    torch.cuda.synchronize()
    nfa_kernels.reset_launches()
    got = [d.fetch_framed(d.dispatch_framed(p, o)) for p, o in frames]
    torch.cuda.synchronize()
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK] == 2
    for g, (p, o) in zip(got, frames):
        assert np.array_equal(g, h.fetch_framed(h.dispatch_framed(p, o)))
    assert got[2][-1]


def test_backend_cpu_files_exact_in_a_cuda_process(dev, tmp_path,
                                                   monkeypatch):
    """--backend cpu through the user's entry point in a process that has
    initialised CUDA: the auto rule narrows the indexed engine on the
    card, and every file holds exactly the `re` oracle's lines; the DFA
    engine's files too."""
    import asyncio
    import re

    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster
    from klogs_tpu_torch.filters import sink as sink_mod

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    torch.zeros(1, device=dev)
    assert torch.cuda.is_initialized()
    made = []
    real = sink_mod.make_pipeline

    def capture(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(sink_mod, "make_pipeline", capture)
    for k, pats in ((2, ["ERROR", r"latency=4\dms"]),
                    (70, [f"seq={i}\\b" for i in range(70)])):
        fc = FakeCluster.synthetic(n_pods=4, lines_per_container=300)
        out = tmp_path / str(k)
        opts = cli.parse_args(["-n", "default", "-a", "--backend", "cpu",
                               "-p", str(out),
                               *sum((["--match", p] for p in pats), [])])
        assert asyncio.run(app.run_async(opts, backend=fc)) == 0
        union = re.compile("|".join(f"(?:{p})" for p in pats).encode())
        for name, pod in fc.namespaces["default"].items():
            want = b"".join(ln for _, ln in pod.containers["c0"].lines
                            if union.search(ln.rstrip(b"\n")))
            assert (out / f"{name}__c0.log").read_bytes() == want
    from klogs_tpu_torch.filters.indexed import IndexedFilter

    assert isinstance(made[1].log_filter, IndexedFilter)
    assert made[1].log_filter._sweep_path == "device"


@pytest.mark.parametrize("grid", [(4, 1), (2, 2), (1, 4)])
def test_mesh_on_card_equals_single_engine_k32(dev, grid):
    """A grid over [cuda:0] x 4: the same verdicts as the single engine on
    short lines in several width buckets and long lines; K1 and
    pack_classify_rows launch once a shard a bucket holding lines, and the long
    lines' K2 on the first device."""
    from klogs_tpu_torch.parallel.mesh import MeshEngine

    rng = np.random.default_rng(11)
    lines = [rng.integers(32, 127, size=int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 9000, size=300)]
    lines += [b"panic: now", b"start", b"the end", b"x" * 5000 + b"code=503"]
    single = GpuEngineFilter(PATTERNS, device=dev).match_lines(lines)
    eng = MeshEngine(PATTERNS, devices=[dev] * 4, grid=grid)
    f = GpuEngineFilter(PATTERNS, engine=eng)
    assert f.device == dev
    nfa_kernels.reset_launches()
    assert f.match_lines(lines) == single
    k1 = nfa_kernels.LAUNCHES[nfa_kernels.GROUPED]
    assert k1 > 0 and k1 % grid[1] == 0
    assert nfa_kernels.LAUNCHES[nfa_kernels.CHUNK] > 0
    assert sum(single) >= 4


def test_mesh_on_card_equals_single_engine_k1024(dev, monkeypatch):
    """K = 1024 over a (2, 2) grid on [cuda:0] x 4: every shard sweeps its
    own 512 patterns on the card and runs K3; the verdicts equal the
    single engine's."""
    from chip_smoke import make_patterns, minted_needle

    from klogs_tpu_torch.cluster.fake import synthetic_line
    from klogs_tpu_torch.parallel.mesh import MeshEngine

    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    pats = make_patterns(1024)
    lines = []
    for i in range(3000):
        ln = synthetic_line(f"pod-{i % 64:04d}", "c0", i, 1.7e9 + i)
        if i % 37 == 0:
            ln = ln[:30] + minted_needle(i * 7 % 1000) + ln[30:]
        lines.append(ln)
    single = GpuEngineFilter(pats, device=dev).match_lines(lines)
    eng = MeshEngine(pats, devices=[dev] * 4, grid=(2, 2))
    assert eng.swept
    nfa_kernels.reset_launches()
    got = GpuEngineFilter(pats, engine=eng).match_lines(lines)
    assert got == single
    assert nfa_kernels.LAUNCHES[nfa_kernels.GATED] > 0
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED] == 0
    assert any(got) and not all(got)


@pytest.mark.parametrize("prefilter", ["0", "1"], ids=["k1", "gated"])
def test_card_spans_hold_the_card_time(dev, prefilter, monkeypatch):
    """A traced engine run: every ``card.*`` child lies inside its
    ``card.batch`` (the pair-CNF gate as ``card.gate``), and the
    ``card.batch`` spans hold at least 99% of ``torch.profiler``'s kernel
    time of the run: both on the host's real-time clock."""
    from torch.profiler import ProfilerActivity, profile

    from klogs_tpu_torch.filters import gpu
    from klogs_tpu_torch.filters.base import frame_lines
    from klogs_tpu_torch.obs import trace

    monkeypatch.setenv("KLOGS_TPU_PREFILTER", prefilter)
    rng = np.random.default_rng(11)
    lines = [b"retry %d/5 code=%d" % (i, 500 + i % 7) if i % 9 == 0
             else b"quiet line %d of the run" % i for i in range(6000)]
    lines += [b"x" * int(n) + b" disk is full" for n in
              rng.integers(8000, 60000, size=24)]
    payload, offsets = frame_lines(lines)[:2]
    filt = GpuEngineFilter(PATTERNS, device=dev)
    assert (filt._pf_tables is not None) == (prefilter == "1")
    want = filt.fetch_framed(filt.dispatch_framed(payload, offsets))
    gpu.anchor_card_clock(dev)
    trace.reset(1.0)
    spans = []
    trace.TRACER.add_sink(spans.append)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with trace.TRACER.span("coalescer.dispatch"):
                handles = [filt.dispatch_framed(payload, offsets)
                           for _ in range(4)]
            got = [filt.fetch_framed(h) for h in handles]
    finally:
        trace.reset(None)
    assert all(np.array_equal(g, want) for g in got) and want.any()
    batches = {s["span_id"]: s for s in spans if s["name"] == "card.batch"}
    assert len(batches) == 4
    kids = [s for s in spans if s["name"].startswith("card.")
            and s["name"] != "card.batch"]
    assert {s["name"] for s in kids} == (
        {"card.copy", "card.pack", "card.match", "card.long",
         "card.verdicts"} | ({"card.gate"} if prefilter == "1" else set()))
    for s in kids:
        b = batches[s["parent_id"]]
        assert s["start_unix"] >= b["start_unix"] - 1e-6
        assert (s["start_unix"] + s["duration_s"]
                <= b["start_unix"] + b["duration_s"] + 1e-6)
    for b in batches.values():
        assert b["attrs"]["launches"] == 1 + sum(
            s["attrs"]["chunks"] for s in kids
            if s["parent_id"] == b["span_id"] and s["name"] == "card.long")
    held = sorted((b["start_unix"], b["start_unix"] + b["duration_s"])
                  for b in batches.values())
    total = inside = 0.0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if ("CUDA" not in str(e.device_type())
                or name.startswith(("Memcpy", "Memset"))):
            continue
        a = e.start_ns() / 1e9
        z = a + e.duration_ns() / 1e9
        total += z - a
        inside += sum(max(0.0, min(z, y) - max(a, x)) for x, y in held)
    assert total > 0
    assert inside >= 0.99 * total, (inside, total)
