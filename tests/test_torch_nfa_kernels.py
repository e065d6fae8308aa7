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
from klogs_tpu.filters.compiler.glushkov import compile_patterns as jax_compile
from klogs_tpu.filters.tpu import classify_chunk_host
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu.ops import pallas_nfa
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.ops import nfa, nfa_kernels

NEEDLES = [b"panic:", b"code=503", b"retry 3/5", b"uid=1234567",
           b"FATAL x code=9", b"latency=495ms", b"broken pipe", b"EPIPE"]


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
    tp, _, _ = nfa.compile_grouped(bench.PATTERNS)
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
    tp, live, acc = nfa.compile_grouped(patterns)
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
    tp, live, acc = nfa.compile_grouped(["ab"])
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


def test_chunk_plain_equals_pallas_chained():
    """Long lines chained chunk by chunk with the carry: lines ending on
    a chunk edge (END deferred to the next chunk), inside a chunk, and
    before the last chunk; matched flags and carries equal per chunk."""
    pats = bench.PATTERNS
    union = compile_patterns(pats)
    tp = nfa.pack_program(nfa.augment(union))
    jdp = jnfa.pack_program(jnfa.augment(jax_compile(pats)), dtype=jnp.int8)
    live, acc = union.n_states, union.n_states + 1
    L = 48
    lens = np.array([0, 1, L - 1, L, L + 1, 2 * L, 2 * L + 5, 3 * L, 3 * L - 2,
                     100, 130, 144], np.int32)
    B, n_chunks = len(lens), 3
    rows, _ = seeded_rows(11, B, n_chunks * L)
    rows[5, 2 * L - 6:2 * L] = np.frombuffer(b"panic:", np.uint8)  # ends on edge
    rows[7, L - 3:L + 3] = np.frombuffer(b"EPIPE!", np.uint8)  # spans an edge
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
    prog = nfa.pack_program(nfa.augment(compile_patterns(pats)))
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


def test_wrappers_count_only_kernel_launches():
    """The plain versions (CPU tensors) never count as launches."""
    nfa_kernels.reset_launches()
    tp, live, acc = nfa.compile_grouped(["abc"])
    cls = torch.full((4, 5), tp.pad_class, dtype=torch.int16)
    nfa_kernels.match_cls_grouped(tp, live, acc, cls)
    assert nfa_kernels.LAUNCHES == {nfa_kernels.GROUPED: 0,
                                    nfa_kernels.CHUNK: 0}


def test_wrappers_reject_mismatched_programs():
    tp, live, acc = nfa.compile_grouped(["abc"])
    single = nfa.pack_program(nfa.augment(compile_patterns(["abc"])))
    cls = torch.zeros((2, 4), dtype=torch.int16)
    with pytest.raises(ValueError):
        nfa_kernels.match_cls_grouped(single, live, acc, cls)
    with pytest.raises(ValueError):
        nfa_kernels.match_chunk_cls(tp, acc, cls,
                                    torch.zeros((2, 128), dtype=torch.int8))
