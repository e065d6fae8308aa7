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
], ids=["w4", "w8", "w16", "w32", "wide", "exceptions", "word_edge"])
def test_fused_kernel_equals_plain_and_k1(dev, patterns, needles):
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    for cls in grouped_batches(prog, needles, dev):
        B = cls.shape[0]
        got = nfa_kernels.match_cls_grouped_fused(prog, live, acc, cls)
        exp = nfa_kernels.match_cls_grouped_fused_plain(prog, live, acc, cls)
        assert got.dtype == torch.bool and got.shape == (B,)
        assert torch.equal(got, exp)
        assert torch.equal(got, nfa_kernels.match_cls_grouped(prog, live, acc,
                                                              cls))


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
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK] > 0
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
# words, each with several groups.
GATED_CASES = [
    PATTERNS + [f"t{i:02d}lit" for i in range(40)],
    ["a" * 200 + "b", r"x\d+y"] + [f"lit{i:02d}x" for i in range(40)],
    ["b" * 400 + "c", "panic:"] + [f"v{i:02d}yz" for i in range(40)],
    ["q" * 600 + "z", "panic:"] + [f"u{i:02d}yz" for i in range(40)],
    ["q" * 1100 + "z", "panic:"] + [f"w{i:02d}yz" for i in range(40)],
]


@pytest.mark.parametrize("patterns", GATED_CASES,
                         ids=["w4", "w8", "w16", "w32", "wide"])
def test_gated_kernel_equals_plain(dev, patterns):
    """K3 against its plain version under random gates: all ones, dense,
    sparse and empty, each over lines whose second half has no gate bit
    (a dead half)."""
    from klogs_tpu_torch.ops import bits

    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    G = int(prog.follow.shape[0])
    assert G > 1
    rng = np.random.default_rng(G)
    for B, T, share in ((1, 5, 1.0), (300, 67, 0.5), (1000, 131, 0.02),
                        (700, 40, 0.0), (513, 99, 1.0)):
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


def test_async_service_many_batches_in_flight(dev, monkeypatch):
    """48 distinct framed batches through AsyncFilterService, each its own
    dispatch (COALESCE_LINES at 1), up to 16 in flight, each with long
    lines that keep the card busy while later batches are staged: the
    verdicts equal the CPU engine's, so no pinned staging buffer was
    rewritten under a copy still in flight."""
    import asyncio

    from klogs_tpu_torch.filters import async_service
    from klogs_tpu_torch.filters.base import frame_lines

    monkeypatch.setattr(async_service, "COALESCE_LINES", 1)
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
    svc = async_service.AsyncFilterService(GpuEngineFilter(PATTERNS,
                                                           device=dev))

    async def go():
        res = await asyncio.gather(*[svc.match_framed(p, o)
                                     for p, o in batches])
        await svc.aclose()
        return res

    nfa_kernels.reset_launches()
    got = asyncio.run(go())
    assert svc.batches_dispatched == len(batches)
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK] >= 2 * len(batches)
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
    pack_rows once, and a long line K2, with the CPU engine's verdicts."""
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
        assert nfa_kernels.LAUNCHES[nfa_kernels.PACK] == 1 + 2 * long_
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
    for k in (nfa_kernels.GROUPED, nfa_kernels.CHUNK, nfa_kernels.PACK):
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
    for k in (nfa_kernels.GROUPED, nfa_kernels.CHUNK, nfa_kernels.PACK):
        assert launches[k] > 0, launches
