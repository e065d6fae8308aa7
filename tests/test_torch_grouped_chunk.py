"""K2g, the long lines' chunk step over the grouped automata
(``nfa_kernels.match_chunk_cls_grouped``), on the CPU: its plain version
chained chunk by chunk gives exactly the verdicts of the JAX package's
union chunk kernel (Pallas, interpret mode), and ``GpuEngineFilter``'s
grouped long-line route gives the JAX engine's and ``re``'s, at register
widths and past 32 words (the wide kernel's groups). Inputs are made
with numpy from a seed; long-line batches hold at most 8 rows."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from klogs_tpu.filters.compiler.glushkov import compile_patterns as jax_compile
from klogs_tpu.filters.tpu import NFAEngineFilter, classify_chunk_host
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu.ops import pallas_nfa
from klogs_tpu_torch.filters import gpu
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.filters.gpu import GpuEngineFilter
from klogs_tpu_torch.ops import nfa, nfa_kernels

ALPHABET = b"ab01 -x.AB"
ATOMS = ["a", "b", "0", "1", "x", "ab", "b0", "[ab]", "[0-9]", r"\d", ".",
         "-", "A", "[^a ]", r"\w"]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain step's batched products on one thread: several test
    processes each spreading them over every core slow each other to a
    crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_pattern(rng) -> str:
    """A short regex over ``ATOMS``: a few atoms, some repeated or
    alternated, a fifth of them anchored at either end."""
    parts = []
    for _ in range(int(rng.integers(1, 5))):
        atom = ATOMS[int(rng.integers(len(ATOMS)))]
        kind = int(rng.integers(6))
        if kind == 0:
            atom = f"(?:{atom})+"
        elif kind == 1:
            atom = f"(?:{atom})*"
        elif kind == 2:
            atom = f"(?:{atom}|{ATOMS[int(rng.integers(len(ATOMS)))]})"
        parts.append(atom)
    pat = "".join(parts)
    if rng.random() < 0.2:
        pat = "^" + pat
    if rng.random() < 0.2:
        pat = pat + "$"
    return pat


def oracle(patterns, line: bytes, ignore_case: bool = False) -> bool:
    flags = re.IGNORECASE if ignore_case else 0
    return any(re.search(p.encode(), line, flags) for p in patterns)


def long_rows(rng, lens, width: int):
    """[len(lens), width] bytes of ``ALPHABET``."""
    idx = rng.integers(0, len(ALPHABET), size=(len(lens), width))
    return np.frombuffer(ALPHABET, np.uint8)[idx], np.asarray(lens, np.int32)


# (seed, patterns in the set, max_positions of the grouping, -I, chunk L)
SETS = [(1, 1, 126, False, 32), (2, 4, 8, False, 32), (3, 12, 16, True, 48),
        (4, 7, 126, False, 48), (5, 12, 6, False, 32),
        (6, 9, 12, True, 32)]


def jax_union(pats, ignore_case: bool = False):
    """The JAX package's augmented union program, live and acc."""
    union = jax_compile(pats, ignore_case=ignore_case)
    return (jnfa.pack_program(jnfa.augment(union), dtype=jnp.int8),
            union.n_states, union.n_states + 1)


def chained(tp, live, acc, ref, rows, lens, L, n_chunks):
    """K2g's plain version and the JAX union kernel (``ref``: program,
    live, acc) chained over the chunks: the verdicts equal on the final
    chunk; returns K2g's final carry and verdicts."""
    jdp, jlive, jacc = ref
    B = rows.shape[0]
    v = nfa_kernels.initial_state_grouped(tp, live, B)
    jv = pallas_nfa.initial_state_kernel(jdp, jlive, B)
    tab = np.asarray(jdp.byte_class).astype(np.int8)
    for k in range(n_chunks):
        chunk = np.ascontiguousarray(rows[:, k * L:(k + 1) * L])
        rem = lens - k * L
        first, final = k == 0, k == n_chunks - 1
        cls = nfa.classify_chunk(tp, torch.from_numpy(chunk),
                                 torch.from_numpy(rem), first, final)
        hcls = classify_chunk_host(chunk, rem, tab, jdp.begin_class,
                                   jdp.end_class, jdp.pad_class, first, final)
        v, m = nfa_kernels.match_chunk_cls_grouped(tp, live, acc, cls, v,
                                                   final)
        jv, jm = pallas_nfa.match_chunk_cls_pallas(
            jdp, jacc, hcls.astype(np.int32), jv, final=final,
            tile_b=8, interpret=True)
        if final:
            assert m.tolist() == np.asarray(jm).tolist()
    return v, m


@pytest.mark.parametrize("seed,k,max_pos,ignore_case,L", SETS)
def test_plain_chained_equals_jax_union(seed, k, max_pos, ignore_case, L):
    """Random sets of 1-12 patterns (anchors, -I), grouped into one or
    many automata, over lines of 2-3 chunks: empty, ending inside a
    chunk, on a chunk edge (END deferred to the next chunk) and before
    the last chunk. The OR over groups of the carried grouped state is
    the union's verdict, and ``re``'s."""
    rng = np.random.default_rng(seed)
    pats = []
    while len(pats) < k:
        p = random_pattern(rng)
        try:
            jax_compile([p])
        except Exception:
            continue
        pats.append(p)
    tp, live, acc = nfa.compile_grouped(pats, ignore_case=ignore_case,
                                        max_positions=max_pos, device="cpu")
    ref = jax_union(pats, ignore_case)
    n_chunks = 3
    lens = [0, L - 3, L, 2 * L, 2 * L + 7, 3 * L - 1, 3 * L, L + 1]
    rows, lens = long_rows(rng, lens, n_chunks * L)
    v, m = chained(tp, live, acc, ref, rows, lens, L, n_chunks)
    assert v.shape == (8, tp.follow.shape[0], 4) and v.dtype == torch.int32
    assert m.tolist() == [oracle(pats, bytes(r[:n]), ignore_case)
                          for r, n in zip(rows, lens)]


def test_plain_chained_equals_jax_union_past_32_words():
    """The watch list (1,028 positions) puts every group of its set at
    1152 states (36 words, the wide kernel's): K2g's plain version
    chained over 3 chunks equals the JAX union kernel and ``re``, with
    watch needles inside a chunk, across a chunk edge, ending on one,
    and near misses; the carry is [B, G, 36] words."""
    pats = [chip_smoke.WATCH, "ab0", "x-1"]
    tp, live, acc = nfa.compile_grouped(pats, device="cpu")
    G = tp.follow.shape[0]
    assert G == 2 and nfa_kernels.grouped_state_words(tp) == 36
    L, n_chunks = 48, 3
    lens = [0, L - 3, L, 2 * L, 2 * L + 7, 3 * L - 1, 3 * L, L + 1]
    rows, lens = long_rows(np.random.default_rng(36), lens, n_chunks * L)
    for i, nd, end in ((2, b"pod=pod-0007", L), (3, b"pod=pod-0255", L + 5),
                       (4, b"pod=pod-0002", 70), (5, b"pod=pod-0129", 130),
                       (6, b"pod=pod-025", 3 * L), (7, b"pod=pod-0001", L + 1)):
        rows[i, end - len(nd):end] = np.frombuffer(nd, np.uint8)
    v, m = chained(tp, live, acc, jax_union(pats), rows, lens, L, n_chunks)
    assert v.shape == (8, G, 36) and v.dtype == torch.int32
    want = [oracle(pats, bytes(r[:n])) for r, n in zip(rows, lens)]
    assert m.tolist() == want
    assert want[2] and want[3] and want[5] and want[7] and not all(want)


def test_match_all_set_and_needles_on_the_edges():
    """A ``match_all`` set verdicts every line on the final chunk only;
    needles ending on a chunk edge and spanning one are found in a set
    of several groups."""
    pats = ["ab0", "x-1", "^0a", "1b$", "a|"]
    tp, live, acc = nfa.compile_grouped(pats, max_positions=4, device="cpu")
    assert tp.match_all and tp.follow.shape[0] > 1
    L = 32
    rows, lens = long_rows(np.random.default_rng(9), [40, 64, 96, 70], 3 * L)
    _, m = chained(tp, live, acc, jax_union(pats), rows, lens, L, 3)
    assert m.tolist() == [True] * 4
    cls = torch.zeros((4, L), dtype=torch.int16) + tp.pad_class
    _, m = nfa_kernels.match_chunk_cls_grouped(
        tp, live, acc, cls, nfa_kernels.initial_state_grouped(tp, live, 4),
        final=False)
    assert m.tolist() == [False] * 4

    pats = ["ab01", "x-x-", "1b1b", "0000"]
    tp, live, acc = nfa.compile_grouped(pats, max_positions=5, device="cpu")
    assert tp.follow.shape[0] == 4
    rows, lens = long_rows(np.random.default_rng(10), [64, 80, 90, 96], 3 * L)
    rows[0, L - 4:L] = np.frombuffer(b"ab01", np.uint8)  # ends on an edge
    rows[1, 2 * L - 2:2 * L + 2] = np.frombuffer(b"x-x-", np.uint8)
    rows[3, 3 * L - 4:3 * L] = np.frombuffer(b"1b1b", np.uint8)
    _, m = chained(tp, live, acc, jax_union(pats), rows, lens, L, 3)
    assert m.tolist()[0] and m.tolist()[1] and m.tolist()[3]
    assert m.tolist() == [oracle(pats, bytes(r[:n]))
                          for r, n in zip(rows, lens)]


def test_carry_words_and_shapes():
    """The carry is [B, G, W] int32 words with ``live``'s bit in every
    (line, group); a carry of another shape or type raises."""
    tp, live, acc = nfa.compile_grouped(["ab", "0+1"], max_positions=3,
                                        device="cpu")
    v = nfa_kernels.initial_state_grouped(tp, live, 3)
    G = tp.follow.shape[0]
    assert v.shape == (3, G, 4) and v.dtype == torch.int32
    # live = S - 2 = 126: bit 30 of word 3.
    assert live == 126 and (v[:, :, 3] == 1 << 30).all()
    assert (v[:, :, :3] == 0).all()
    cls = torch.full((3, 5), tp.pad_class, dtype=torch.int16)
    for bad in (v[:2], v.long(), v[:, :, :2]):
        with pytest.raises(ValueError, match="v0"):
            nfa_kernels.match_chunk_cls_grouped(tp, live, acc, cls, bad)
    union = nfa.pack_program(nfa.augment(compile_patterns(["ab", "0+1"])),
                             device="cpu")
    with pytest.raises(ValueError, match="compile_grouped"):
        nfa_kernels.match_chunk_cls_grouped(union, live, acc, cls, v)


ENGINE_PATS = ["panic:", r"retry \d+/\d+", "code=50[34]", "^start", "end$",
               r"(?:FATAL|CRIT).*code=\d+"]


def engine_lines(seed: int, chunk: int) -> list:
    rng = np.random.default_rng(seed)
    needles = [b"panic:", b"retry 4/9", b"code=503", b"FATAL at code=7",
               b"start", b"end"]
    lines = [b"", b"start here", b"the end\n", b"code=502"]
    for i, n in enumerate(rng.integers(0, 3 * chunk, size=20)):
        body = bytearray(rng.integers(32, 127, size=int(n)).astype(np.uint8))
        if i % 3 == 0 and n > 20:
            nd = needles[i % len(needles)]
            p = int(rng.integers(0, int(n) - len(nd)))
            body[p:p + len(nd)] = nd
        lines.append(bytes(body) + (b"\n" if i % 2 else b""))
    lines += [b"a" * chunk, b"a" * (chunk - 3) + b"panic:",
              b"b" * (2 * chunk - 3) + b"end", b"start" + b"c" * (2 * chunk),
              b"c" * (2 * chunk - 2) + b"retry 1/2"]
    return lines


def test_engine_grouped_route_equals_jax(monkeypatch):
    """With the route's bound patched to 0, a small set's long lines
    take K2g (the union is never built, and K2 is never called): the
    verdicts on short, long and over-SEQ_SCAN_BYTES lines are the JAX
    engine's and ``re``'s."""
    monkeypatch.setattr(gpu, "GROUPED_LONG_STATES", 0)

    def no_union(*a, **kw):
        raise AssertionError("K2 on the grouped route")

    monkeypatch.setattr(nfa_kernels, "match_chunk_cls", no_union)
    chunk = 256
    port = GpuEngineFilter(ENGINE_PATS, chunk_bytes=chunk, device="cpu")
    assert port._long is not None and port._aug is None
    assert port._long[0] is port._grouped
    lines = engine_lines(5, chunk)
    ref = NFAEngineFilter(ENGINE_PATS, chunk_bytes=chunk, kernel="interpret")
    got = port.match_lines(lines)
    assert got == ref.match_lines(lines)
    assert got == [oracle(ENGINE_PATS, ln.rstrip(b"\n")) for ln in lines]
    huge = b"x" * (GpuEngineFilter.SEQ_SCAN_BYTES + 700)
    pats = ["needle", "^x+$"]
    port = GpuEngineFilter(pats, chunk_bytes=4096, device="cpu")
    assert port._long is not None
    lines = [huge, huge[:-1] + b"y", b"y" * 5000 + b"needle", b"short needle"]
    got = port.match_lines(lines)
    assert got == [True, False, True, True]
    assert got == NFAEngineFilter(pats, kernel="interpret").match_lines(lines)


def test_group_past_a_register_width_takes_the_grouped_route(monkeypatch,
                                                              capsys):
    """A single pattern of more than ~1000 positions makes a group past
    32 words (36) and a union past 1024 states: the filter takes K2g over
    the grouped automata (its wide kernel on the card), builds no union
    and says nothing; K2 is never called, and long lines get ``re``'s
    verdicts."""
    def no_union(*a, **kw):
        raise AssertionError("K2 on the grouped route")

    monkeypatch.setattr(nfa_kernels, "match_chunk_cls", no_union)
    pats = ["q" * 1100 + "z", "panic:"]
    port = GpuEngineFilter(pats, chunk_bytes=256, device="cpu")
    assert nfa_kernels.grouped_state_words(port._grouped) == 36
    assert port._long is not None and port._aug is None
    assert port._long[0] is port._grouped
    assert capsys.readouterr() == ("", "")
    lines = [b"q" * 1100 + b"z", b"q" * 1099 + b"z", b"x" * 300 + b"panic:",
             b"y" * 700]
    assert port.match_lines(lines) == [True, False, True, False]


# make_patterns(80) of chip_smoke.py (bench.make_patterns): the 32
# patterns, then the minted families in turn, i = 0..47.
K80_FAMILIES = [
    lambda i: f"svc-{i:04d} unreachable",
    lambda i: rf"errcode={i:05d}\b",
    lambda i: f"tenant-{i:04d}.*quota exceeded",
    lambda i: rf"CRIT{i:05d}",
    lambda i: rf"trace=[0-9a-f]+ span={i:06d}",
    lambda i: f"deploy/rel-{i:04d} failed",
    lambda i: rf"(?:FATAL|PANIC) job-{i:05d}",
    lambda i: rf"user=u{i:06d} denied",
]


def k80_patterns() -> list:
    import bench

    return list(bench.PATTERNS) + [K80_FAMILIES[i % 8](i) for i in range(48)]


def test_union_past_1024_states_takes_the_grouped_route():
    """80 patterns: a union of 1,298 states (past K2's register widths)
    sends long lines to K2g unpatched; no union program is built, and
    lines of 4-12 KiB get ``re``'s verdicts."""
    import bench

    pats = k80_patterns()
    assert pats == bench.make_patterns(80)
    port = GpuEngineFilter(pats, device="cpu")
    assert port._aug is None and port._long is not None
    assert nfa_kernels.kernel_states(nfa.padded_states(1298)) > \
        gpu.GROUPED_LONG_STATES
    rng = np.random.default_rng(80)
    needles = [b"svc-0040 unreachable", b"errcode=00041", b"CRIT00043",
               b"tenant-0042 over quota exceeded", b"user=u000047 denied",
               b"panic:", b"svc-0099 unreachable"]
    lines = []
    for i in range(8):
        n = int(rng.integers(4 * 1024, 12 * 1024 + 1))
        body = bytearray(rng.integers(32, 127, size=n).astype(np.uint8))
        nd = needles[i % len(needles)]
        p = 4096 - len(nd) // 2 if i == 2 else int(rng.integers(0, n - 30))
        body[p:p + len(nd)] = nd
        lines.append(bytes(body))
    lines += [b"svc-0040 unreachable", b"nothing here"]
    got = port.match_lines(lines)
    assert got == [oracle(pats, ln) for ln in lines]
    assert sum(got) >= 6
