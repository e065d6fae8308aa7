"""The port's device literal sweep (ops/sweep.py, on device "cpu")
equals ``klogs_tpu.ops.sweep.sweep_group_candidates`` on the cases of
tests/test_sweep.py: mixed tiers, boundary placements, a factor across
two lines, the overlong cap, inert padded rows and a seeded random
property; plus the packed words K3 reads. Exact equality."""

import random
import re

import numpy as np
import pytest
import torch

import bench
from klogs_tpu.filters.compiler.groups import analyze as janalyze
from klogs_tpu.filters.compiler.groups import plan_groups as jplan_groups
from klogs_tpu.filters.compiler.index import FactorIndex as JFactorIndex
from klogs_tpu.ops import sweep as jsweep
from klogs_tpu_torch.filters.compiler.groups import analyze, plan_groups
from klogs_tpu_torch.filters.compiler.index import SWEEP_FACTOR_CAP, FactorIndex
from klogs_tpu_torch.ops import bits, sweep


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALPHA = b"abcdef0123-=/ :"


def pack(lines, width=None):
    w = width if width is not None else max([len(ln) for ln in lines] + [1])
    batch = np.zeros((len(lines), w), dtype=np.uint8)
    for i, ln in enumerate(lines):
        batch[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
    return batch, np.asarray([len(ln) for ln in lines], dtype=np.int32)


def masks(pats, lines, width=None, **plan_kw):
    """(port mask, JAX mask, port index) on the same lines."""
    infos, jinfos = analyze(pats), janalyze(pats)
    idx = FactorIndex(infos, plan_groups(infos, **plan_kw))
    jidx = JFactorIndex(jinfos, jplan_groups(jinfos, **plan_kw))
    batch, lens = pack(lines, width)
    st = sweep.device_sweep_tables(idx.sweep_program(), device="cpu")
    got = sweep.sweep_group_candidates(st, torch.from_numpy(batch),
                                       torch.from_numpy(lens)).numpy()
    exp = np.asarray(jsweep.sweep_group_candidates(
        jsweep.device_sweep_tables(jidx.sweep_program()), batch, lens))
    return got, exp, idx


def test_mixed_tiers():
    pats = ["ERR!", "panic: out of memory", "x!z", "FATAL|CRIT",
            r"[a-z]*\d?"]
    lines = [b"an ERR! line", b"panic: out of memory now", b"ax!zb",
             b"CRIT boom", b"benign", b"", b"x!z",
             b"panic: out of memor_", b"ERR", b"FATA"]
    got, exp, _ = masks(pats, lines, max_group_patterns=2)
    assert np.array_equal(got, exp)
    assert got.any() and not got.all()


def test_boundary_placements():
    lines = [b"headlit rest", b"ends with tail4", b"headlit", b"tail4",
             b"headli", b"ail4", b"", b"x"]
    got, exp, _ = masks(["headlit", "tail4"], lines)
    assert np.array_equal(got, exp)
    assert got[:4].any(axis=1).all() and not got[4:].any()


def test_cross_line_factor():
    """Packed rows never see a factor split over two lines."""
    lines = [b"abcd", b"efgh", b"ww", b"xyz", b"xabcdefghx"]
    got, exp, _ = masks(["abcdefgh", "wxyz"], lines)
    assert np.array_equal(got, exp)
    assert not got[0].any() and not got[1].any() and got[4].any()


def test_overlong_factor_cap():
    lit = "prefix-" + "q" * SWEEP_FACTOR_CAP + "-suffix"
    lines = [lit.encode(), lit.encode()[:-4], b"other-lit here",
             b"no hits at all", b"q" * SWEEP_FACTOR_CAP]
    got, exp, _ = masks([lit, "other-lit"], lines)
    assert np.array_equal(got, exp)


def test_padded_rows_inert():
    pats = ["needle-lit", "ha[yx]stack"]
    lines = [b"a needle-lit b", b"haystack", b"nothing"]
    tight, exp, _ = masks(pats, lines)
    wide, wexp, _ = masks(pats, lines, width=256)
    assert np.array_equal(tight, exp) and np.array_equal(wide, wexp)
    assert np.array_equal(tight, wide)


def test_random_property():
    """Random literal sets, lines with factors planted at offset 0,
    flush right and in between: equal masks, and no true match hidden
    (necessity)."""
    rng = random.Random(20260803)
    for _ in range(10):
        pats = []
        for _ in range(rng.randrange(2, 10)):
            n = rng.randrange(3, 14)
            pats.append(re.escape("".join(
                chr(ALPHA[rng.randrange(len(ALPHA))]) for _ in range(n))))
        lines = []
        for _ in range(40):
            body = bytes(ALPHA[rng.randrange(len(ALPHA))]
                         for _ in range(rng.randrange(0, 48)))
            if rng.random() < 0.5:
                raw = pats[rng.randrange(len(pats))].replace("\\", "").encode()
                at = rng.choice([0, len(body), rng.randrange(len(body) + 1)])
                body = body[:at] + raw + body[at:]
            lines.append(body)
        got, exp, idx = masks(pats, lines, max_group_patterns=3)
        assert np.array_equal(got, exp), (pats, lines)
        for i, line in enumerate(lines):
            for p, pat in enumerate(pats):
                if re.search(pat.encode(), line):
                    assert got[i, int(idx._group_of[p])], (pat, line)


def test_k1024_retargeted_words_on_bench_lines():
    """The thousand-pattern tables against compile_grouped's groups, on
    FakeCluster lines with minted-family needles: the packed words
    unpack to the JAX mask, and chunking the rows changes nothing."""
    from klogs_tpu.ops import nfa as jnfa

    pats = bench.make_patterns(1024)
    jdp, _, _ = jnfa.compile_grouped(pats)
    pg, G = np.asarray(jdp.pattern_group, np.int32), int(jdp.follow.shape[0])
    infos = analyze(pats)
    prog = FactorIndex(infos, plan_groups(infos)).sweep_program(
        group_of=pg, n_groups=G)
    jinfos = janalyze(pats)
    jprog = JFactorIndex(jinfos, jplan_groups(jinfos)).sweep_program(
        group_of=pg, n_groups=G)
    lines = [ln.rstrip(b"\n") for ln in bench.make_lines(300)]
    lines += [b"x svc-0008 unreachable", b"errcode=00009 y",
              b"tenant-0010 over quota exceeded", b"CRIT00011",
              b"trace=ab12 span=000012", b"deploy/rel-0013 failed",
              b"PANIC job-00014", b"user=u000015 denied"]
    batch, lens = pack(lines, width=160)
    st = sweep.device_sweep_tables(prog, device="cpu")
    words = sweep.sweep_group_bits(st, torch.from_numpy(batch),
                                   torch.from_numpy(lens))
    assert words.shape == (len(lines), 5)
    exp = np.asarray(jsweep.sweep_group_candidates(
        jsweep.device_sweep_tables(jprog), batch, lens))
    assert np.array_equal(bits.unpack_bits(words, G).numpy(), exp)
    assert exp[-8:].any(axis=1).all()
    old = sweep.CHUNK_ELEMS
    try:
        sweep.CHUNK_ELEMS = 160 * 7  # 7 rows a chunk
        again = sweep.sweep_group_bits(st, torch.from_numpy(batch),
                                       torch.from_numpy(lens))
    finally:
        sweep.CHUNK_ELEMS = old
    assert torch.equal(words, again)


def test_empty_and_validation():
    infos = analyze(["aaaa-lit"])
    st = sweep.device_sweep_tables(
        FactorIndex(infos, plan_groups(infos)).sweep_program(), device="cpu")
    empty = sweep.sweep_group_candidates(
        st, torch.zeros((0, 16), dtype=torch.uint8),
        torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 1)
    with pytest.raises(ValueError, match="uint8"):
        sweep.sweep_group_bits(st, torch.zeros((2, 4), dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 156])
def test_bit_helpers(n):
    rng = np.random.default_rng(n)
    flags = torch.from_numpy(rng.random((7, n)) < 0.3)
    words = bits.pack_bits(flags)
    assert words.shape == (7, (n + 31) // 32)
    assert torch.equal(bits.unpack_bits(words, n), flags)
    assert torch.equal(bits.unpack_bits(bits.to_int32(words).long(), n),
                       flags)
    a = torch.from_numpy(rng.integers(0, 2**32, size=50, dtype=np.int64))
    k = 2654435761
    assert bits.mul32(a, k).tolist() == [(int(x) * k) % 2**32 for x in a]
    x = torch.from_numpy(rng.integers(0, 2**32, size=(3, n), dtype=np.int64))
    exp = [int(np.bitwise_or.reduce(r)) for r in x.numpy()]
    assert bits.or_reduce(x).tolist() == exp
