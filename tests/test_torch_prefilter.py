"""The port's pair-CNF masks and candidate clustering (ops/prefilter.py,
on device "cpu") equal the JAX package's: class_tables leaves,
candidate_matrix_from_cls, candidate_matrix, group_candidates and
cluster_candidates (order, inv, tile_live). Exact equality."""

import numpy as np
import pytest
import torch

import bench
from klogs_tpu.filters.compiler.prefilter import compile_prefilter as jcompile
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu.ops import prefilter as jpf
from klogs_tpu_torch.filters.compiler.prefilter import (
    candidate_matrix_host,
    compile_prefilter,
)
from klogs_tpu_torch.ops import nfa
from klogs_tpu_torch.ops import prefilter as pf


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SETS = {
    "k64": bench.make_patterns(64),
    "bench": bench.PATTERNS,
    "short": ["ab", "x[yz]w", "q-r"],
}


def corpus(seed: int, B: int = 70, width: int = 96):
    rng = np.random.default_rng(seed)
    lines = [ln.rstrip(b"\n")[:width] for ln in bench.make_lines(B - 12)]
    lines += [b"svc-0008 unreachable", b"errcode=00009", b"", b"a",
              b"panic: now", b"retry 3/5", b"x-request-id: 9f", b"ab",
              b"xzw", b"q-r", b"CRIT00011 code=7",
              rng.integers(32, 127, size=width, dtype=np.uint8).tobytes()]
    batch = np.zeros((len(lines), width), dtype=np.uint8)
    for i, ln in enumerate(lines):
        batch[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
    return lines, batch, np.asarray([len(ln) for ln in lines], np.int32)


@pytest.fixture(scope="module", params=sorted(SETS))
def programs(request):
    pats = SETS[request.param]
    tp, jp = compile_prefilter(pats), jcompile(pats)
    dp, _, _ = nfa.compile_grouped(pats, device="cpu")
    jdp, _, _ = jnfa.compile_grouped(pats)
    return pats, tp, jp, dp, jdp


def test_compile_prefilter_equals_jax(programs):
    _, tp, jp, _, _ = programs
    assert tp.usable == jp.usable and tp.clause_counts == jp.clause_counts
    for name in ("lut1", "lut2", "req"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name))


def test_class_tables_equal_jax(programs):
    _, tp, jp, dp, jdp = programs
    got = pf.class_tables(tp, dp.byte_class.numpy(), dp.n_classes,
                          device="cpu")
    exp = jpf.class_tables(jp, jdp.byte_class, jdp.n_classes)
    assert len(got) == len(exp) == 4
    for a, b in zip(got, exp):
        assert a.numpy().dtype == np.asarray(b).dtype
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_class_tables_shapes(programs):
    """One slot column per LUT bit and one requirement per pattern, each
    with a clause (the tables exist only for a usable program)."""
    pats, tp, _, dp, _ = programs
    m1, m2, req_t, req_count = pf.class_tables(
        tp, dp.byte_class.numpy(), dp.n_classes, device="cpu")
    S = tp.lut1.shape[1] * 32
    assert m1.shape == m2.shape == (dp.n_classes, S)
    assert req_t.shape == (S, len(pats)) and req_count.shape == (len(pats),)
    assert (req_count > 0).all()
    assert torch.equal(req_count, req_t.sum(0, dtype=torch.int32))


def test_candidate_matrices_equal_jax(programs):
    _, tp, jp, dp, jdp = programs
    lines, batch, lens = corpus(3)
    cls = nfa.classify_chunk(dp, torch.from_numpy(batch),
                             torch.from_numpy(lens), True, True)
    tt = pf.class_tables(tp, dp.byte_class.numpy(), dp.n_classes,
                         device="cpu")
    jt = jpf.class_tables(jp, jdp.byte_class, jdp.n_classes)
    got = pf.candidate_matrix_from_cls(tt, cls).numpy()
    exp = np.asarray(jpf.candidate_matrix_from_cls(
        jt, cls.numpy().astype(np.int32)))
    assert np.array_equal(got, exp)
    host = candidate_matrix_host(tp, lines)
    assert np.array_equal(got, host)
    byte = pf.candidate_matrix(pf.device_tables(tp, device="cpu"),
                               torch.from_numpy(batch),
                               torch.from_numpy(lens)).numpy()
    assert np.array_equal(byte, np.asarray(jpf.candidate_matrix(
        jpf.device_tables(jp), batch, lens)))
    assert np.array_equal(byte, host)
    assert host.any()


def test_group_candidates_equal_jax(programs):
    pats, tp, jp, dp, jdp = programs
    _, batch, lens = corpus(4)
    pm = pf.candidate_matrix(pf.device_tables(tp, device="cpu"),
                             torch.from_numpy(batch), torch.from_numpy(lens))
    G = int(dp.follow.shape[0])
    onehot = pf.pattern_group_onehot(dp.pattern_group, G, device="cpu")
    jonehot = jpf.pattern_group_onehot(jdp.pattern_group, G)
    assert np.array_equal(onehot.numpy(), np.asarray(jonehot))
    got = pf.group_candidates(pm, onehot, len(pats)).numpy()
    exp = np.asarray(jpf.group_candidates(pm.numpy(), jonehot, len(pats)))
    assert np.array_equal(got, exp)


def test_short_rows():
    """Widths 0 and 1 hold no byte pair: no pattern is a candidate
    (a usable set has a clause per pattern)."""
    tp = compile_prefilter(["ab", "cd"])
    tabs = pf.device_tables(tp, device="cpu")
    for L in (0, 1):
        got = pf.candidate_matrix(tabs, torch.zeros((3, L), dtype=torch.uint8),
                                  torch.zeros(3, dtype=torch.int32))
        assert got.shape == (3, 2) and not got.any()
    dp, _, _ = nfa.compile_grouped(["ab", "cd"], device="cpu")
    ct = pf.class_tables(tp, dp.byte_class.numpy(), dp.n_classes,
                         device="cpu")
    assert not pf.candidate_matrix_from_cls(
        ct, torch.zeros((2, 1), dtype=torch.int16)).any()


def test_class_tables_refuse_unusable():
    tp = compile_prefilter(["ab", ".*"])
    assert not tp.usable
    assert pf.class_tables(tp, np.zeros(256, np.int32), 8,
                           device="cpu") is None


@pytest.mark.parametrize("B,tile,share", [(64, 16, 0.3), (128, 32, 0.0),
                                          (96, 8, 1.0), (160, 32, 0.05)])
def test_cluster_candidates_equal_jax(B, tile, share):
    cand = np.random.default_rng(B + tile).random(B) < share
    order, inv, live, n_cand = pf.cluster_candidates(torch.from_numpy(cand),
                                                     tile)
    jorder, jinv, jlive = jpf.cluster_candidates(cand, tile)
    assert int(n_cand) == int(cand.sum())
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    assert np.array_equal(inv.numpy(), np.asarray(jinv))
    assert np.array_equal(live.numpy(), np.asarray(jlive))
    assert np.array_equal(cand[order.numpy()][inv.numpy()], cand)
    n = int(cand.sum())
    assert cand[order.numpy()][:n].all() and not cand[order.numpy()][n:].any()


def test_cluster_candidates_ragged_tail():
    """B need not divide the tile here: the last, short tile counts."""
    cand = torch.zeros(10, dtype=torch.bool)
    cand[9] = True
    order, inv, live, n_cand = pf.cluster_candidates(cand, 4)
    assert order[0] == 9 and inv[9] == 0 and int(n_cand) == 1
    assert live.tolist() == [1, 0, 0]
