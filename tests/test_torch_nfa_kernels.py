"""The kernels' plain versions equal the Pallas kernels (interpret mode)
on the same class ids, and the port's classify_chunk equals the JAX
package's host classifier. Exact equality: verdicts and carried states
are booleans."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from klogs_tpu.filters.compiler.glushkov import compile_patterns as jax_compile
from klogs_tpu.filters.tpu import classify_chunk_host
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu.ops import pallas_nfa
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.ops import nfa, nfa_kernels, pack

NEEDLES = [b"panic:", b"code=503", b"retry 3/5", b"uid=1234567",
           b"FATAL x code=9", b"latency=495ms", b"broken pipe", b"EPIPE"]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions' batched products on one thread: several test
    processes each spreading them over every core slow each other to a
    crawl (the wide cases step 1152-state groups)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_rows(seed: int, B: int, width: int, lo: int = 0):
    """[B, width] uint8 rows (printable bytes, planted needles) and [B]
    lengths in [lo, width], from a numpy Generator."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, width + 1, size=B).astype(np.int32)
    rows = rng.integers(32, 127, size=(B, width)).astype(np.uint8)
    for i in range(0, B, 2):
        nd = NEEDLES[(i // 2) % len(NEEDLES)]
        if lens[i] >= len(nd):
            p = rng.integers(0, lens[i] - len(nd) + 1)
            rows[i, p:p + len(nd)] = np.frombuffer(nd, dtype=np.uint8)
    return rows, lens


def host_table(jdp):
    return np.asarray(jdp.byte_class).astype(np.int8)


@pytest.mark.parametrize("first,final", [(True, True), (True, False),
                                         (False, False), (False, True)])
def test_classify_chunk_equals_host(first, final):
    jdp, _, _ = jnfa.compile_grouped(bench.PATTERNS)
    tp, _, _ = nfa.compile_grouped(bench.PATTERNS, device="cpu")
    L = 16
    rows, _ = seeded_rows(3, 12, L)
    # Ended lines, END on every edge of the window, and continuing ones.
    rem = np.array([-5, -1, 0, 1, 7, 15, 16, 17, 18, 40, 3, 16], np.int32)
    got = nfa.classify_chunk(tp, torch.from_numpy(rows), torch.from_numpy(rem),
                             first, final)
    exp = classify_chunk_host(rows, rem, host_table(jdp), jdp.begin_class,
                              jdp.end_class, jdp.pad_class, first, final)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), exp)


@pytest.mark.parametrize("patterns", [
    bench.PATTERNS,
    [f"needle{i}" for i in range(30)],
    ["^start", "end$", "a|"],
    [r"[a-m]+X", r"[h-z]+Y", r"\d\d", "q"],
], ids=["bench", "needles", "match_all", "clash"])
def test_grouped_plain_equals_pallas(patterns):
    tp, live, acc = nfa.compile_grouped(patterns, device="cpu")
    jdp, _, _ = jnfa.compile_grouped(patterns)
    rows, lens = seeded_rows(7, 48, 64)
    cls = nfa.classify_chunk(tp, torch.from_numpy(rows), torch.from_numpy(lens),
                             True, True)
    got = nfa_kernels.match_cls_grouped(tp, live, acc, cls).numpy()
    exp = np.asarray(pallas_nfa.match_cls_grouped_pallas(
        jdp, live, acc, cls.numpy().astype(np.int32), tile_b=16,
        interpret=True))
    assert np.array_equal(got, exp)
    oracle = [any(re.search(p.encode(), bytes(r[:n])) for p in patterns)
              for r, n in zip(rows, lens)]
    assert got.tolist() == oracle


def test_grouped_plain_kills_out_of_range_classes():
    """A class id outside [0, C) zeroes the state (the one-hot product's
    semantics), in the plain version as in the Pallas kernel."""
    tp, live, acc = nfa.compile_grouped(["ab"], device="cpu")
    jdp, _, _ = jnfa.compile_grouped(["ab"])
    a, b = (int(tp.byte_class[ord(ch)]) for ch in "ab")
    C = tp.n_classes
    cls = np.array([[tp.begin_class, a, b, tp.end_class, tp.pad_class],
                    [tp.begin_class, a, C + 3, tp.end_class, tp.pad_class],
                    [tp.begin_class, -1, a, b, tp.end_class]], np.int32)
    got = nfa_kernels.match_cls_grouped(tp, live, acc, torch.from_numpy(cls))
    exp = np.asarray(pallas_nfa.match_cls_grouped_pallas(
        jdp, live, acc, cls, tile_b=8, interpret=True))
    assert got.tolist() == exp.tolist() == [True, False, False]


@pytest.mark.parametrize("pats,edge,across,states", [
    (["panic:", r"retry \d+/\d+", "code=50[34]", "^start", "end$",
      r"(?:FATAL|CRIT).*code=\d+", "disk .*full"], b"panic:", b"code=503",
     128),
    (["a" * 200 + "b", r"x\d+y"], b"x1234y", b"x99y", 256),
    (bench.PATTERNS, b"panic:", b"EPIPE!", 512),
    (["q" * 1000 + "z", "panic:"], b"panic:", b"panic:", 1024),
], ids=["s128", "s256", "s512", "s1024"])
def test_chunk_plain_equals_pallas_chained(pats, edge, across, states):
    """Long lines chained chunk by chunk with the carry: lines ending on
    a chunk edge (END deferred to the next chunk), inside a chunk, and
    before the last chunk; matched flags and carries equal per chunk.
    One union program per register width of the CUDA kernel (4, 8, 16
    and 32 state words): the plain version it is held against on the
    card is held against the Pallas kernel at each."""
    union = compile_patterns(pats)
    tp = nfa.pack_program(nfa.augment(union), device="cpu")
    assert tp.n_states == states
    jdp = jnfa.pack_program(jnfa.augment(jax_compile(pats)), dtype=jnp.int8)
    live, acc = union.n_states, union.n_states + 1
    L = 48
    lens = np.array([0, 1, L - 1, L, L + 1, 2 * L, 2 * L + 5, 3 * L, 3 * L - 2,
                     100, 130, 144], np.int32)
    B, n_chunks = len(lens), 3
    rows, _ = seeded_rows(11, B, n_chunks * L)
    # Row 5 ends on an edge with a needle; row 7's needle spans one.
    rows[5, 2 * L - len(edge):2 * L] = np.frombuffer(edge, np.uint8)
    p = L - len(across) // 2
    rows[7, p:p + len(across)] = np.frombuffer(across, np.uint8)
    v = nfa_kernels.initial_state(tp, live, B)
    jv = pallas_nfa.initial_state_kernel(jdp, live, B)
    tab = host_table(jdp)
    for k in range(n_chunks):
        chunk = np.ascontiguousarray(rows[:, k * L:(k + 1) * L])
        rem = lens - k * L
        first, final = k == 0, k == n_chunks - 1
        cls = nfa.classify_chunk(tp, torch.from_numpy(chunk),
                                 torch.from_numpy(rem), first, final)
        hcls = classify_chunk_host(chunk, rem, tab, jdp.begin_class,
                                   jdp.end_class, jdp.pad_class, first, final)
        assert np.array_equal(cls.numpy(), hcls)
        v, m = nfa_kernels.match_chunk_cls(tp, acc, cls, v, final)
        jv, jm = pallas_nfa.match_chunk_cls_pallas(
            jdp, acc, hcls.astype(np.int32), jv, final=final, tile_b=8,
            interpret=True)
        assert v.dtype == torch.int8
        assert np.array_equal(v.numpy(), np.asarray(jv))
        assert np.array_equal(m.numpy(), np.asarray(jm))
    oracle = [any(re.search(p.encode(), bytes(r[:n])) for p in pats)
              for r, n in zip(rows, lens)]
    assert m.tolist() == oracle
    assert m[5] and m[7]


def test_bit_table_layout():
    """Bit b of word w is column 32w+b, as the kernels read it."""
    t = torch.zeros((2, 64), dtype=torch.int8)
    t[0, 0] = t[0, 31] = t[1, 33] = 1
    bits = nfa_kernels.bit_table(t)
    assert bits.dtype == torch.int32
    assert bits.tolist() == [[1 | -(1 << 31), 0], [0, 2]]


@pytest.mark.parametrize("S,expected", [
    (128, 128), (256, 256), (384, 512), (512, 512), (640, 1024),
    (1024, 1024), (1152, 1152), (1536, 1536)])
def test_kernel_states_rounds_to_register_widths(S, expected):
    """Up to 32 words a program runs at a register width (4, 8, 16, 32
    words); past that the wide kernels take S as it is."""
    assert nfa_kernels.kernel_states(S) == expected


def test_bit_tables_pad_with_dead_states():
    """A 640-state union program gets 1024-state bit tables whose added
    rows and columns are all zero, and whose first 640 decode to the
    program's own follow and mask tables."""
    pats = ["q" * 600 + "z", "panic:"]
    prog = nfa.pack_program(nfa.augment(compile_patterns(pats)),
                            device="cpu")
    assert prog.n_states == 640
    follow_bits, mask_bits = nfa_kernels._bit_tables(prog)
    assert follow_bits.shape == (1024, 32)
    assert mask_bits.shape == (prog.n_classes, 32)

    def unpack(bits):
        words = bits.to(torch.int64) & 0xFFFFFFFF
        shifts = torch.arange(32, dtype=torch.int64)
        return ((words.unsqueeze(-1) >> shifts) & 1).flatten(-2)

    follow, mask = unpack(follow_bits), unpack(mask_bits)
    assert torch.equal(follow[:640, :640], prog.follow.to(torch.int64))
    assert not follow[640:].any() and not follow[:, 640:].any()
    assert torch.equal(mask[:, :640], prog.char_mask.to(torch.int64))
    assert not mask[:, 640:].any()


def test_wrappers_count_only_kernel_launches(monkeypatch):
    """The plain versions (CPU tensors) never count as launches."""
    nfa_kernels.reset_launches()
    tp, live, acc = nfa.compile_grouped(["abc"], device="cpu")
    cls = torch.full((4, 5), tp.pad_class, dtype=torch.int16)
    nfa_kernels.match_cls_grouped(tp, live, acc, cls)
    nfa_kernels.match_cls_grouped_fused(tp, live, acc, cls)
    nfa_kernels.match_cls_grouped_gated(
        tp, live, acc, cls, torch.ones((4, 1), dtype=torch.int64))
    nfa_kernels.match_chunk_cls_grouped(
        tp, live, acc, cls, nfa_kernels.initial_state_grouped(tp, live, 4))
    pack.pack_rows(torch.zeros(4, dtype=torch.uint8),
                   torch.zeros(2, dtype=torch.int64),
                   torch.full((2,), 4, dtype=torch.int64), 8, 4)
    pack.pack_classify_rows(torch.zeros(4, dtype=torch.uint8),
                            torch.zeros(2, dtype=torch.int64),
                            torch.full((2,), 4, dtype=torch.int64), 8, 4, tp)
    # Past 32 words (a 1152-state group): the wide kernels' plain versions.
    wp, wl, wa = nfa.compile_grouped(["q" * 1100 + "z"], device="cpu")
    assert nfa_kernels.grouped_state_words(wp) == 36
    wcls = torch.full((4, 5), wp.pad_class, dtype=torch.int16)
    nfa_kernels.match_cls_grouped(wp, wl, wa, wcls)
    nfa_kernels.match_cls_grouped_fused(wp, wl, wa, wcls)
    nfa_kernels.match_cls_grouped_gated(
        wp, wl, wa, wcls, torch.ones((4, 1), dtype=torch.int64))
    nfa_kernels.match_chunk_cls_grouped(
        wp, wl, wa, wcls, nfa_kernels.initial_state_grouped(wp, wl, 4))
    # Past 160 words (a 5632-state group): the shared-memory kernels'.
    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "8192")
    sp, sl, sa = nfa.compile_grouped(["q" * 5600 + "z"], device="cpu")
    assert nfa_kernels.grouped_state_words(sp) == 176
    scls = torch.full((2, 3), sp.pad_class, dtype=torch.int16)
    nfa_kernels.match_cls_grouped(sp, sl, sa, scls)
    nfa_kernels.match_cls_grouped_fused(sp, sl, sa, scls)
    nfa_kernels.match_cls_grouped_gated(
        sp, sl, sa, scls, torch.ones((2, 1), dtype=torch.int64))
    nfa_kernels.match_chunk_cls_grouped(
        sp, sl, sa, scls, nfa_kernels.initial_state_grouped(sp, sl, 2))
    assert nfa_kernels.LAUNCHES == {nfa_kernels.GROUPED: 0,
                                    nfa_kernels.GATED: 0,
                                    nfa_kernels.CHUNK: 0,
                                    nfa_kernels.FUSED: 0,
                                    nfa_kernels.GROUPED_CHUNK: 0,
                                    nfa_kernels.GROUPED_WIDE: 0,
                                    nfa_kernels.GROUPED_CHUNK_WIDE: 0,
                                    nfa_kernels.GATED_WIDE: 0,
                                    nfa_kernels.FUSED_WIDE: 0,
                                    nfa_kernels.GROUPED_SMEM: 0,
                                    nfa_kernels.GROUPED_CHUNK_SMEM: 0,
                                    nfa_kernels.GATED_SMEM: 0,
                                    nfa_kernels.FUSED_SMEM: 0,
                                    nfa_kernels.PAIRS: 0,
                                    nfa_kernels.PACK_CLS: 0,
                                    nfa_kernels.PACK: 0}


def test_smem_route_and_too_wide_group():
    """Past 160 words the route is the shared-memory kernels' at any
    width whose one warp's two buffers fit a block's shared memory
    (29056 words); the launch of a wider group raises
    GroupTooWideError before it reaches the card."""
    nfa_kernels._check_width(164)
    nfa_kernels._check_width(29056)
    with pytest.raises(nfa_kernels.GroupTooWideError):
        nfa_kernels._check_width(29057)
    assert [nfa_kernels._route(w) for w in (4, 32, 36, 160, 164, 2048)] == [
        "register", "register", "wide", "wide", "smem", "smem"]


def test_wrappers_reject_mismatched_programs():
    tp, live, acc = nfa.compile_grouped(["abc"], device="cpu")
    single = nfa.pack_program(nfa.augment(compile_patterns(["abc"])),
                              device="cpu")
    cls = torch.zeros((2, 4), dtype=torch.int16)
    with pytest.raises(ValueError):
        nfa_kernels.match_cls_grouped(single, live, acc, cls)
    with pytest.raises(ValueError):
        nfa_kernels.match_chunk_cls(tp, acc, cls,
                                    torch.zeros((2, 128), dtype=torch.int8))


# ---- K3: the gated grouped kernel's plain version ------------------------

K64 = bench.make_patterns(64)
MINTED = [b"svc-0008 unreachable", b"errcode=00009", b"CRIT00011",
          b"tenant-0010 x quota exceeded", b"deploy/rel-0013 failed",
          b"svc-0001 unreachable", b"trace=ab span=000012"]


def k64_rows(seed: int, B: int = 48, width: int = 64):
    """[B, width] rows: FakeCluster-like printable bytes, the 32-set's
    needles and minted-family needles (some near misses)."""
    rows, lens = seeded_rows(seed, B, width)
    rng = np.random.default_rng(seed + 1)
    for i in range(1, B, 3):
        nd = MINTED[(i // 3) % len(MINTED)]
        lens[i] = max(lens[i], len(nd))
        p = int(rng.integers(0, lens[i] - len(nd) + 1))
        rows[i, p:p + len(nd)] = np.frombuffer(nd, dtype=np.uint8)
    return rows, lens


def k64_programs(pats: list = K64):
    from klogs_tpu_torch.filters.compiler.groups import analyze, plan_groups
    from klogs_tpu_torch.filters.compiler.index import FactorIndex

    tp, live, acc = nfa.compile_grouped(pats, device="cpu")
    jdp, _, _ = jnfa.compile_grouped(pats)
    infos = analyze(pats)
    prog = FactorIndex(infos, plan_groups(infos)).sweep_program(
        group_of=np.asarray(tp.pattern_group, np.int32),
        n_groups=int(tp.follow.shape[0]))
    return tp, jdp, live, acc, prog


def test_gated_plain_equals_pallas_sweep():
    """Under the literal sweep's gate: the same verdicts and candidate
    count as the JAX fused path (sweep + gated Pallas kernel)."""
    from klogs_tpu.ops.sweep import device_sweep_tables as jtables
    from klogs_tpu_torch.ops import sweep

    tp, jdp, live, acc, prog = k64_programs()
    rows, lens = k64_rows(21)
    exp, jstats = pallas_nfa.match_batch_grouped_pallas(
        jdp, live, acc, rows, lens, tile_b=16, interpret=True,
        sweep_tables=jtables(prog), return_stats=True)
    batch, lengths = torch.from_numpy(rows), torch.from_numpy(lens)
    cls = nfa.classify_chunk(tp, batch, lengths, True, True)
    words = sweep.sweep_group_bits(
        sweep.device_sweep_tables(prog, device="cpu"), batch, lengths)
    got, stats = nfa_kernels.match_cls_grouped_gated(tp, live, acc, cls,
                                                     words, want_stats=True)
    assert got.tolist() == np.asarray(exp).tolist()
    assert int(stats[0]) == int(jstats[0])
    assert got.tolist() == [any(re.search(p.encode(), bytes(r[:n]))
                                for p in K64) for r, n in zip(rows, lens)]
    assert got.any()


def test_gated_plain_equals_pallas_prefilter():
    """Under the class-domain pair-CNF gate: the same verdicts and
    candidate count as the JAX gated kernel over class ids."""
    from klogs_tpu.filters.compiler.prefilter import compile_prefilter as jcp
    from klogs_tpu.ops import prefilter as jpf
    from klogs_tpu_torch.filters.compiler.prefilter import compile_prefilter
    from klogs_tpu_torch.ops import bits, prefilter

    tp, jdp, live, acc, _ = k64_programs()
    rows, lens = k64_rows(22)
    cls = nfa.classify_chunk(tp, torch.from_numpy(rows),
                             torch.from_numpy(lens), True, True)
    jt = jpf.class_tables(jcp(K64), jdp.byte_class, jdp.n_classes)
    exp, jstats = pallas_nfa.match_cls_grouped_pallas(
        jdp, live, acc, cls.numpy().astype(np.int32), tile_b=16,
        interpret=True, prefilter_tables=jt, return_stats=True)
    tt = prefilter.class_tables(compile_prefilter(K64), tp.byte_class.numpy(),
                                tp.n_classes, device="cpu")
    onehot = prefilter.pattern_group_onehot(
        tp.pattern_group, tp.follow.shape[0], device="cpu")
    gm = prefilter.group_candidates(
        prefilter.candidate_matrix_from_cls(tt, cls), onehot, len(K64))
    got, stats = nfa_kernels.match_cls_grouped_gated(
        tp, live, acc, cls, bits.pack_bits(gm), want_stats=True)
    assert got.tolist() == np.asarray(exp).tolist()
    assert int(stats[0]) == int(jstats[0])


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_gated_plain_formula_under_random_gate(dtype):
    """out[b] = OR over g of (gate[b, g] and group g accepts b): groups
    partition the patterns, so 'group g accepts b' is 're finds one of
    g's patterns in b'. A random gate drops real matches; K1's verdict
    is the all-ones gate."""
    from klogs_tpu_torch.ops import bits

    tp, _, live, acc, _ = k64_programs()
    rows, lens = k64_rows(23)
    cls = nfa.classify_chunk(tp, torch.from_numpy(rows),
                             torch.from_numpy(lens), True, True)
    G = int(tp.follow.shape[0])
    gate = np.random.default_rng(5).random((len(rows), G)) < 0.5
    words = bits.pack_bits(torch.from_numpy(gate))
    if dtype == torch.int32:
        words = bits.to_int32(words)
    got, stats = nfa_kernels.match_cls_grouped_gated(tp, live, acc, cls,
                                                     words, want_stats=True)
    exp = [any(gate[b, tp.pattern_group[p]]
               and re.search(pat.encode(), bytes(rows[b, :lens[b]]))
               for p, pat in enumerate(K64)) for b in range(len(rows))]
    assert got.tolist() == exp
    k1 = nfa_kernels.match_cls_grouped(tp, live, acc, cls)
    assert sum(exp) < int(k1.sum())
    full = bits.pack_bits(torch.ones((len(rows), G), dtype=torch.bool))
    assert torch.equal(nfa_kernels.match_cls_grouped_gated(
        tp, live, acc, cls, full)[0], k1)
    B = len(rows)
    assert stats.tolist() == [int(gate.any(1).sum()),
                              -(-int(gate.any(1).sum()) // 128), -(-B // 128)]


def sweep_gate(prog, rows, lens):
    """The literal sweep's [B, GW] words, and JAX's gated verdicts and
    stats under the same sweep."""
    from klogs_tpu.ops.sweep import device_sweep_tables as jtables
    from klogs_tpu_torch.ops import sweep

    return (sweep.sweep_group_bits(
        sweep.device_sweep_tables(prog, device="cpu"), torch.from_numpy(rows),
        torch.from_numpy(lens)),
        dict(sweep_tables=jtables(prog)))


def pair_cnf_gate(tp, jdp, cls, pats: list = K64):
    """The class-domain pair-CNF gate's [B, GW] words, and JAX's gated
    kernel arguments for the same gate."""
    from klogs_tpu.filters.compiler.prefilter import compile_prefilter as jcp
    from klogs_tpu.ops import prefilter as jpf
    from klogs_tpu_torch.filters.compiler.prefilter import compile_prefilter
    from klogs_tpu_torch.ops import bits, prefilter

    tt = prefilter.class_tables(compile_prefilter(pats),
                                tp.byte_class.numpy(), tp.n_classes,
                                device="cpu")
    onehot = prefilter.pattern_group_onehot(
        tp.pattern_group, tp.follow.shape[0], device="cpu")
    gm = prefilter.group_candidates(
        prefilter.candidate_matrix_from_cls(tt, cls), onehot, len(pats))
    return bits.pack_bits(gm), dict(prefilter_tables=jpf.class_tables(
        jcp(pats), jdp.byte_class, jdp.n_classes))


@pytest.mark.parametrize("kind", ["sweep", "pair_cnf"])
def test_gate_pairs_and_plain_versions_equal_pallas(kind):
    """Under each gate of the thousand-pattern path: the plain pair list
    holds exactly the gate's (line, group) bits, group-major; K3's
    plain version from the gate and from the pair list give JAX's gated
    Pallas verdicts (interpret mode), and the pair count is the gated
    cells' and the candidate count JAX's."""
    gated_against_pallas(kind, K64, *k64_rows(26))


# The thousand-pattern path with one wide group: make_patterns(64) and
# the watch list (chip_smoke.WATCH, 1,028 positions) put all 10 groups
# at 1152 states (36 words), the width of K3's wide kernel on the card.
K64W = K64 + [chip_smoke.WATCH]
WATCH_NEEDLES = [b"pod=pod-0001", b"x pod=pod-0255 y", b"pod=pod-0002",
                 b"pod=pod-013", b"pod=pod-0129"]


def k64w_rows(seed: int):
    """16 rows of 45 bytes (T = 48): ``k64_rows`` with watch-list needles
    (two near misses) planted in every fourth row."""
    rows, lens = k64_rows(seed, B=16, width=45)
    for i in range(3, 16, 4):
        nd = WATCH_NEEDLES[(i // 4) % len(WATCH_NEEDLES)]
        lens[i] = max(lens[i], len(nd) + 2)
        rows[i, 2:2 + len(nd)] = np.frombuffer(nd, dtype=np.uint8)
    return rows, lens


@pytest.mark.parametrize("kind", ["sweep", "pair_cnf"])
def test_gate_pairs_and_plain_versions_equal_pallas_wide(kind):
    """As above on the set whose groups are all 36 words: K3's plain
    version, which the card's wide K3 is held against, gives JAX's gated
    verdicts and candidate count under each gate."""
    tp = gated_against_pallas(kind, K64W, *k64w_rows(27))
    assert tp.follow.shape[0] == 10
    assert nfa_kernels.kernel_states(tp.n_states) == 32 * 36


def gated_against_pallas(kind: str, pats: list, rows, lens):
    """The checks of the two tests above on one set and batch; returns
    the port's program."""
    from klogs_tpu_torch.ops import bits

    tp, jdp, live, acc, prog = k64_programs(pats)
    cls = nfa.classify_chunk(tp, torch.from_numpy(rows),
                             torch.from_numpy(lens), True, True)
    if kind == "sweep":
        words, jkw = sweep_gate(prog, rows, lens)
        exp, jstats = pallas_nfa.match_batch_grouped_pallas(
            jdp, live, acc, rows, lens, tile_b=16, interpret=True,
            return_stats=True, **jkw)
    else:
        words, jkw = pair_cnf_gate(tp, jdp, cls, pats)
        exp, jstats = pallas_nfa.match_cls_grouped_pallas(
            jdp, live, acc, cls.numpy().astype(np.int32), tile_b=16,
            interpret=True, return_stats=True, **jkw)
    G = int(tp.follow.shape[0])
    cells = bits.unpack_bits(words, G)  # [B, G]
    pairs, n_pairs, stats = nfa_kernels.gate_pairs(words, G)
    n = int(n_pairs)
    listed = pairs[:n].long()
    assert n == int(cells.sum()) > 0
    assert torch.equal(listed, torch.sort(listed).values)
    assert cells[listed % len(rows), listed // len(rows)].all()
    assert int(stats[0]) == int(jstats[0]) == int(cells.any(1).sum())
    exp = np.asarray(exp).tolist()
    assert nfa_kernels.launch_gated_plain(tp, live, acc, cls, pairs,
                                          n_pairs).tolist() == exp
    assert nfa_kernels.match_cls_grouped_gated_plain(
        tp, live, acc, cls, words).tolist() == exp
    assert exp == [any(re.search(p.encode(), bytes(r[:n])) for p in pats)
                   for r, n in zip(rows, lens)]
    assert any(exp) and not all(exp)
    return tp


def test_gated_plain_counts_only_gated_cells():
    """The plain version's work count (the kernel's operation bound)
    reads state bits on gated (line, group) cells only."""
    from klogs_tpu_torch.ops import bits

    tp, live, acc = nfa.compile_grouped(bench.PATTERNS, device="cpu")
    rows, lens = seeded_rows(24, 16, 32)
    cls = nfa.classify_chunk(tp, torch.from_numpy(rows),
                             torch.from_numpy(lens), True, True)
    G = int(tp.follow.shape[0])
    all_work, none_work = {}, {}
    nfa_kernels.match_cls_grouped_plain(tp, live, acc, cls, work=all_work)
    ones = bits.pack_bits(torch.ones((16, G), dtype=torch.bool))
    nfa_kernels.match_cls_grouped_gated_plain(tp, live, acc, cls, ones,
                                              work=none_work)
    assert none_work == all_work
    zero = torch.zeros((16, 1), dtype=torch.int64)
    work: dict = {}
    got = nfa_kernels.match_cls_grouped_gated_plain(tp, live, acc, cls, zero,
                                                    work=work)
    assert work["active"] == 0 and not got.any()


def test_gated_wrapper_rejects_bad_gates():
    tp, live, acc = nfa.compile_grouped(["abc", "def"], device="cpu")
    cls = torch.zeros((4, 6), dtype=torch.int16)
    with pytest.raises(ValueError, match="gate_bits"):
        nfa_kernels.match_cls_grouped_gated(
            tp, live, acc, cls, torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(TypeError, match="gate_bits"):
        nfa_kernels.match_cls_grouped_gated(
            tp, live, acc, cls, torch.zeros((4, 1), dtype=torch.uint8))
