"""The shift-and-exceptions step of K1 and K4, on the CPU.

``nfa_kernels.shift_constants`` splits each group's padded follow table
into four [W]-word constants (SH, SELF, RL, EX); the kernels step with

    v' = (shl1(v & SH) | (v & SELF) | (live in v ? RL : 0)
          | OR of follow[s] over s in v & EX) & mask[c]

The constants must rebuild every row of the padded table, and a numpy
transcription of that step (a helper of this file, word for word as
the CUDA source runs it, not a second path of the port) must equal the
plain version and the JAX Pallas grouped and fused kernels in interpret
mode on the same class ids. Past 32 words the kernels spread the same
step over a warp a (line, group), lane l owning words l, l+32, ...; a
second transcription steps that layout, the cross-lane carry of shl1
included. Exact equality: verdicts are booleans."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu.ops import pallas_nfa
from klogs_tpu_torch.ops import nfa, nfa_kernels

# A literal whose Glushkov positions run across bits 31 -> 32 (word 0
# into word 1), and on into word 2.
EDGE_PATS = ["abcdefghijklmnopqrstuvwxyz0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ",
             "panic:"]
# Alternations, stars and classes: many states with edges that are
# neither a shift nor a self-loop.
EXC_PATS = [r"(a|b|c)+d", r"x.*y.*z", r"(foo|bar|baz)qux",
            r"[0-9]+(\.[0-9]+)*e", r"(ab|cd)*ef", r"(?:FATAL|CRIT).*code=\d+",
            r"k(e|i)+y", "disk .*full"]
GROUPED_PATS = ["panic:", "code=50[34]", "^FATAL", r"x[0-9]{2,}y", "a.*b.*c",
                r"(?:err|warn)\d+", "end$"] * 3
# The watch list and a few exception-heavy patterns: every group at 1152
# states (36 words), run by the wide kernels.
WIDE_PATS = [chip_smoke.WATCH] + EXC_PATS[:3]
# Past 160 words (the shared-memory kernels), under a raised position
# cap: watch lists of 700 and 1030 pods, 176 and 260 words.
SMEM_PATS = {176: [chip_smoke.watch_list(700)] + EXC_PATS[:3],
             260: [chip_smoke.watch_list(1030)] + EXC_PATS[:3]}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain step's batched products on one thread: several test
    processes each spreading them over every core slow each other to a
    crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def unpack_np(words: np.ndarray, n: int) -> np.ndarray:
    """[..., W] uint32 words -> [..., n] bool (bit b of word j: 32j+b)."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1,
                         bitorder="little")
    return bits[..., :n].astype(bool)


def kernel_operands(prog, live):
    """(follow words [G, Sk, W], constants [G, W, 4], mask words
    [G, C, W], Sk) as the kernels receive them: the follow buffer of
    ``_shift_tables`` cut at its G * Sk * W words."""
    G = prog.follow.shape[0]
    buf, mask = nfa_kernels._shift_tables(prog, live)
    Sk = nfa_kernels.kernel_states(prog.n_states)
    W = Sk // 32
    buf = words_np(buf)
    assert buf.shape == (G * Sk * W + G * W * 4,)
    return (buf[:G * Sk * W].reshape(G, Sk, W),
            buf[G * Sk * W:].reshape(G, W, 4), words_np(mask), Sk)


@pytest.mark.parametrize("patterns,states", [
    (chip_smoke.PATTERNS, 128),
    (["a" * 200 + "b", r"x\d+y"], 256),
    (["q" * 600 + "z", "panic:"], 1024),  # 640 states, padded to 1024
    (EDGE_PATS, 128),
    (EXC_PATS, 128),
    (None, 128),  # chip_smoke.make_patterns(1024): 156 groups
    (WIDE_PATS, 1152),  # past 32 words: the wide kernels' constants
    (SMEM_PATS[176], 5632),  # past 160 words: the shared-memory kernels'
    (SMEM_PATS[260], 8320),
], ids=["bench32", "s256", "s640_padded", "word_edge", "exceptions", "k1024",
        "wide", "smem176", "smem260"])
def test_constants_rebuild_padded_follow(patterns, states, monkeypatch):
    """shl1(SH) | SELF | RL (live's row) | the rows of EX gives back
    every row of each group's padded follow table, and no constant bit
    lies outside it: SH and SELF only where the edge exists, nothing
    past the last state, EX only where a row holds another edge."""
    if patterns is None:
        patterns = chip_smoke.make_patterns(1024)
    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    prog, live, acc = nfa.compile_grouped(patterns, device="cpu")
    follow_w, consts, _, Sk = kernel_operands(prog, live)
    assert Sk == states
    G = prog.follow.shape[0]
    pad = Sk - prog.n_states
    ref = (F.pad(prog.follow, (0, pad, 0, pad)) != 0).numpy()  # [G, Sk, Sk]
    assert np.array_equal(unpack_np(follow_w, Sk), ref)
    sh, self_loop, rl, ex = (unpack_np(consts[..., k], Sk) for k in range(4))
    s = np.arange(Sk)
    rows = np.zeros_like(ref)
    rows[:, s[:-1], s[1:]] = sh[:, :-1]
    rows[:, s, s] |= self_loop
    rows[:, live] |= rl
    rows |= ex[:, :, None] & ref
    assert np.array_equal(rows, ref)
    assert not sh[:, -1].any() and not ex[:, live].any()
    other = ref.copy()
    other[:, s, s] = False
    other[:, s[:-1], s[1:]] = False
    assert np.array_equal(ex, other.any(-1) & (s != live))
    if patterns is chip_smoke.PATTERNS or G == 156:
        # The main path's sets: shift edges are most of the graph, the
        # exception states a few a group (47 over the 4 bench groups).
        assert sh.sum() > 5 * ex.sum()
        assert ex.sum() == 47 if G == 4 else ex.sum() < 12 * G
    if states == 1024:
        assert not (sh | self_loop | ex)[:, prog.n_states:].any()
    if states == 1152:
        # The watch list's group (the largest, binned first): its "=" and
        # the 128 branch ends are its only exception states; its shifts
        # are p-o-d-=, = to the first branch and 7 in each branch.
        assert G == 2 and ex[0].sum() == 129
        assert sh[0].sum() == 3 + 1 + 128 * 7
    if states > 32 * nfa_kernels.WIDE_WORDS:
        # The same for 700 and 1030 pods.
        pods = 700 if states == 5632 else 1030
        assert G == 2 and ex[0].sum() == pods + 1
        assert sh[0].sum() == 3 + 1 + pods * 7


def shift_scan_np(prog, live, acc, cls: np.ndarray):
    """[B, T] class ids -> ([B] bool, exception rows read), stepping
    every (line, group) with the kernels' word arithmetic on the
    kernels' operands: shl1 as a funnel shift carrying bit 31 of word j
    into word j+1, live's row kept by a word mask, the rows of set
    exception bits ORed, an id outside [0, C) reading an all-zero mask
    row."""
    follow_w, consts, mask_w, Sk = kernel_operands(prog, live)
    G, C, W = mask_w.shape
    B, T = cls.shape
    row = np.minimum(cls.astype(np.int64) & 0xFFFFFFFF, C)  # unsigned min
    matched = np.zeros(B, dtype=bool)
    n_exc = 0
    for g in range(G):
        sh, self_loop, rl, ex = (consts[g, :, k] for k in range(4))
        masks = np.concatenate([mask_w[g], np.zeros((1, W), np.uint32)])
        v = np.zeros((B, W), dtype=np.uint32)
        v[:, live >> 5] = np.uint32(1 << (live & 31))
        for t in range(T):
            keep = np.where(v[:, live >> 5] >> np.uint32(live & 31) & 1,
                            np.uint32(0xFFFFFFFF), np.uint32(0))
            a = v & sh
            prev = np.concatenate([np.zeros((B, 1), np.uint32), a[:, :-1]], 1)
            r = (a << np.uint32(1)) | (prev >> np.uint32(31)) | (v & self_loop)
            r |= rl & keep[:, None]
            for n, s in zip(*np.nonzero(unpack_np(v & ex, Sk))):
                r[n] |= follow_w[g, s]
                n_exc += 1
            v = r & masks[row[:, t]]
        matched |= (v[:, acc >> 5] >> np.uint32(acc & 31) & 1).astype(bool)
    return matched | prog.match_all, n_exc


def wide_scan_np(prog, live, acc, cls: np.ndarray):
    """``shift_scan_np`` in the wide kernels' layout: each (line, group)
    a warp, lane l holding words l, l+32, ... (slot i: word l + 32i, 0
    past W). shl1's carry into word j is bit 31 of word j-1: each lane
    ORs its slots' top bits into one word, which a rotating shuffle
    hands to the next lane; lane 0 takes slot i's carry from slot i-1 of
    lane 31's. live's bit is voted on by the lanes; the lanes with a set
    exception bit are balloted and each such bit's follow row is ORed by
    every lane into its own slots."""
    follow_w, consts, mask_w, Sk = kernel_operands(prog, live)
    G, C, W = mask_w.shape
    K = -(-W // 32)
    B, T = cls.shape
    j = np.arange(32)[:, None] + 32 * np.arange(K)[None, :]  # [32, K]

    def lanes(words: np.ndarray) -> np.ndarray:
        """[..., W] words -> [..., 32, K] (lane, slot), 0 past W."""
        return np.where(j < W, words[..., np.minimum(j, W - 1)],
                        np.uint32(0)).astype(np.uint32)

    slots = np.arange(K, dtype=np.uint32)
    row = np.minimum(cls.astype(np.int64) & 0xFFFFFFFF, C)  # unsigned min
    lw, lsh, aw = live >> 5, np.uint32(live & 31), acc >> 5
    matched = np.zeros(B, dtype=bool)
    n_exc = 0
    for g in range(G):
        sh, self_loop, rl, ex = (lanes(consts[g, :, k]) for k in range(4))
        masks = lanes(np.concatenate([mask_w[g], np.zeros((1, W), np.uint32)]))
        rows = lanes(follow_w[g])  # [Sk, 32, K]
        v = np.zeros((B, 32, K), dtype=np.uint32)
        v[:, lw & 31, lw >> 5] = np.uint32(1 << (live & 31))
        for t in range(T):
            lv = np.zeros((32, K), dtype=np.uint32)
            lv[lw & 31, lw >> 5] = np.uint32(1) << lsh
            voted = (v & lv).any(axis=(1, 2))  # the lanes' vote
            keep = np.where(voted, np.uint32(0xFFFFFFFF), np.uint32(0))
            a = v & sh
            top = np.bitwise_or.reduce((a >> np.uint32(31)) << slots, axis=-1)
            prev = np.roll(top, 1, axis=1)  # lane l gets lane l-1's
            carry = prev.copy()
            carry[:, 0] <<= np.uint32(1)  # lane 0: slot i from slot i-1
            r = ((a << np.uint32(1)) | (carry[:, :, None] >> slots & 1)
                 | (v & self_loop) | (rl & keep[:, None, None]))
            e = v & ex
            for n in range(B):
                for q in np.nonzero(e[n].any(axis=-1))[0]:  # the ballot
                    for i in range(K):
                        bits = int(e[n, q, i])
                        while bits:
                            b = (bits & -bits).bit_length() - 1
                            bits &= bits - 1
                            r[n] |= rows[(q + 32 * i) * 32 + b]
                            n_exc += 1
            v = r & masks[row[:, t]]
        matched |= (v[:, aw & 31, aw >> 5] >> np.uint32(acc & 31) & 1) \
            .astype(bool)
    return matched | prog.match_all, n_exc


def smem_scan_np(prog, live, acc, cls: np.ndarray):
    """``shift_scan_np`` as the shared-memory kernels run it past 160
    words: each (line, group) a warp whose state v and next state n are
    two W-word buffers (n starts as garbage: every word of it is written
    each step), a step a loop over the W/32 slices, lane l taking word j0
    + l of slice j0. In a slice, shl1's carry into a lane is its left
    neighbour's top bit of v & SH (a rotating shuffle: lane 0 takes lane
    31's of the slice before), live's bit is read from v's word, and n =
    (shl1 | SELF | RL & live) & mask; the lanes' vote on v & EX sends the
    warp to a second pass over the slices that ORs each set exception
    bit's follow row, masked, into n."""
    follow_w, consts, mask_w, Sk = kernel_operands(prog, live)
    G, C, W = mask_w.shape
    B, T = cls.shape
    row = np.minimum(cls.astype(np.int64) & 0xFFFFFFFF, C)  # unsigned min
    lw, lsh, aw = live >> 5, np.uint32(live & 31), acc >> 5
    one, top_bit = np.uint32(1), np.uint32(31)
    rng = np.random.default_rng(W)
    matched = np.zeros(B, dtype=bool)
    n_exc = 0
    for g in range(G):
        sh, self_loop, rl, ex = (consts[g, :, k] for k in range(4))
        masks = np.concatenate([mask_w[g], np.zeros((1, W), np.uint32)])
        for b in range(B):
            v = np.zeros(W, dtype=np.uint32)
            v[lw] = one << lsh
            n = rng.integers(0, 2**32, size=W, dtype=np.uint32)  # garbage
            for t in range(T):
                keep = bool(v[lw] >> lsh & one)
                m = masks[row[b, t]]
                vote, carry = False, np.uint32(0)
                for j0 in range(0, W, 32):
                    j = np.arange(j0, min(j0 + 32, W))
                    x = v[j]
                    a = x & sh[j]
                    top = np.zeros(32, dtype=np.uint32)  # lanes past W: 0
                    top[:len(j)] = a >> top_bit
                    prev = np.roll(top, 1)  # lane l gets lane l-1's
                    cin = prev[:len(j)].copy()
                    cin[0] = carry
                    carry = prev[0]
                    n[j] = ((a << one) | cin | (x & self_loop[j])
                            | (rl[j] if keep else np.uint32(0))) & m[j]
                    vote |= bool((x & ex[j]).any())
                if vote:  # the second pass
                    for j0 in range(0, W, 32):
                        e = v[j0:j0 + 32] & ex[j0:j0 + 32]
                        for q in np.nonzero(e)[0]:  # the ballot, ascending
                            bits = int(e[q])
                            while bits:
                                bit = (bits & -bits).bit_length() - 1
                                bits &= bits - 1
                                n |= follow_w[g, (j0 + q) * 32 + bit] & m
                                n_exc += 1
                v, n = n, v
            matched[b] |= bool(v[aw] >> np.uint32(acc & 31) & one)
    return matched | prog.match_all, n_exc


def text_rows(seed: int, B: int, width: int, needles: list):
    """[B, width] printable rows, lengths in [0, width], a needle in
    every other row."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(32, 127, size=(B, width), dtype=np.uint8)
    lens = rng.integers(0, width + 1, size=B).astype(np.int32)
    for i in range(0, B, 2):
        nd = needles[(i // 2) % len(needles)]
        if lens[i] >= len(nd):
            p = int(rng.integers(0, lens[i] - len(nd) + 1))
            rows[i, p:p + len(nd)] = np.frombuffer(nd, np.uint8)
    return rows, lens


@pytest.mark.parametrize("patterns,needles,width,max_positions,B", [
    (chip_smoke.PATTERNS, chip_smoke.NEEDLES, 61, 126, 40),
    (EDGE_PATS, [EDGE_PATS[0].encode(), EDGE_PATS[0][:40].encode(),
                 b"panic:"], 77, 126, 40),
    (EXC_PATS, [b"abcd", b"x1y2z", b"bazqux", b"1.2.3e", b"abcdef",
                b"CRIT at code=4", b"keiy", b"disk is full"], 45, 126, 40),
    (GROUPED_PATS, [b"panic: now", b"code=504", b"x123y", b"a-b-c",
                    b"warn77", b"the end"], 32, 24, 40),
    (["a" * 200 + "b", r"x\d+y"], [b"a" * 200 + b"b", b"x12y"], 230, 126,
     40),
    (WIDE_PATS, [b"pod=pod-0001", b"x pod=pod-0255 y", b"pod=pod-0002",
                 b"abcd", b"pod=pod-0254", b"bazqux", b"xy pod=pod-0129"],
     45, 126, 16),
], ids=["bench32", "word_edge", "exceptions", "multi_group", "s256", "wide"])
def test_shift_step_equals_plain_and_pallas(patterns, needles, width,
                                            max_positions, B):
    """The step transcribed from the kernels equals the plain version and
    the Pallas grouped and fused kernels (interpret mode), with class ids
    outside [0, C) (C + 5 and -1) in some rows; the plain version's
    ``work["exc"]`` counts the exception rows the step reads. Past 32
    words the transcription is the wide kernels' lane-owned one."""
    prog, live, acc = nfa.compile_grouped(patterns, device="cpu",
                                          max_positions=max_positions)
    jdp, _, _ = jnfa.compile_grouped(patterns, max_positions=max_positions)
    rows, lens = text_rows(len(patterns) + width, B, width, needles)
    cls = nfa.classify_chunk(prog, torch.from_numpy(rows),
                             torch.from_numpy(lens), True, True)
    T = cls.shape[1]
    cls[3::11, T // 3] = prog.n_classes + 5
    cls[6::13, T // 2] = -1
    words = nfa_kernels.kernel_states(prog.n_states) // 32
    scan = wide_scan_np if words > 32 else shift_scan_np
    got, n_exc = scan(prog, live, acc, cls.numpy())
    work: dict = {}
    plain = nfa_kernels.match_cls_grouped_plain(prog, live, acc, cls,
                                                work=work).numpy()
    assert work["exc"] == n_exc < work["active"]
    c32 = cls.numpy().astype(np.int32)
    grouped = np.asarray(pallas_nfa.match_cls_grouped_pallas(
        jdp, live, acc, c32, tile_b=8, interpret=True))
    fused = np.asarray(pallas_nfa.match_cls_grouped_pallas(
        jdp, live, acc, c32, tile_b=8, interpret=True, fused=True))
    assert np.array_equal(got, plain)
    assert np.array_equal(got, grouped) and np.array_equal(got, fused)
    assert got.any() and not got.all()


# The shared-memory step's cases (patterns, width, lines, needles): the
# 700-pod list (the watch group's states are dense across slices after
# "pod=", until the digits), and a literal whose one thread crosses the
# edge of slices 0 and 1 at state 1024 while live sits in slice 2 (68
# words here: the transcription runs at any width).
SMEM_STEP_CASES = {
    "watch176": (SMEM_PATS[176], 45, 16, [
        b"pod=pod-0255", b"x pod=pod-0511 y", b"pod=pod-1023", b"abcd",
        b"pod=pod-0767", b"pod=pod-1279 bazqux", b"pod=pod-0700",
        b"x pod=pod-1399 y"]),
    "edge68": (["a" + "b" * 2100 + "c", "panic:"], 2110, 6, [
        b"a" + b"b" * 2100 + b"c", b"panic: x", b"a" + b"b" * 2099 + b"c"]),
}


@pytest.mark.parametrize("case", sorted(SMEM_STEP_CASES))
def test_smem_step_equals_plain_and_re(monkeypatch, case):
    """The step transcribed from the shared-memory kernels (past 160
    words: the 700-pod watch list and three exception-heavy patterns, 2
    groups of 5632 states, 176 words; and a literal crossing a slice
    edge) equals the plain version, which equals ``re``, with ids outside
    [0, C) in some rows; the plain version's ``work["exc"]`` counts the
    exception rows it ORs. (The Pallas kernels
    are left out here: a 5632-state product in interpret mode costs
    minutes on one thread.)"""
    import re

    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    pats, width, B, needles = SMEM_STEP_CASES[case]
    prog, live, acc = nfa.compile_grouped(pats, device="cpu")
    rows, lens = text_rows(len(pats) + width, B, width, needles)
    for i in (0, 2):  # the first and last needles whole, in rows 0 and 2
        nd = needles[-i // 2]
        rows[i, :len(nd)] = np.frombuffer(nd, np.uint8)
        lens[i] = len(nd)
    cls = nfa.classify_chunk(prog, torch.from_numpy(rows),
                             torch.from_numpy(lens), True, True)
    T = cls.shape[1]
    cls[3::11, T // 3] = prog.n_classes + 5
    cls[6::13, T // 2] = -1
    got, n_exc = smem_scan_np(prog, live, acc, cls.numpy())
    work: dict = {}
    plain = nfa_kernels.match_cls_grouped_plain(prog, live, acc, cls,
                                                work=work).numpy()
    assert work["exc"] == n_exc < work["active"]
    assert np.array_equal(got, plain)
    words = nfa_kernels.kernel_states(prog.n_states) // 32
    alt = re.compile("|".join(f"(?:{p})" for p in pats).encode())
    clean = [i for i in range(B) if i % 11 != 3 and i % 13 != 6]
    assert [got[i] for i in clean] == [
        alt.search(rows[i, :lens[i]].tobytes()) is not None for i in clean]
    assert got[0] and got.any() and not got.all()
    if case == "watch176":
        assert words == 176 and n_exc > 0
