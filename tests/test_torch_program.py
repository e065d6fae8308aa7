"""The port's NFA programs equal the JAX package's, leaf for leaf.

``klogs_tpu_torch.ops.nfa`` (compile_grouped / augment / pack_program /
program_from_jax) against ``klogs_tpu.ops.nfa`` on the same pattern
sets; exact equality, the tables being 0/1 and small integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from klogs_tpu.filters.compiler.glushkov import compile_patterns as jax_compile
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.ops import nfa


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LEAVES = ("char_mask", "follow", "inject", "accept", "byte_class")
META = ("begin_class", "end_class", "pad_class", "n_classes", "n_states",
        "match_all")

# The pattern sets of tests/test_grouped.py, the bench set, and a
# match-all set.
PATTERN_SETS = [
    [f"pattern{i:02d}[a-z]{{3}}\\d+" for i in range(24)],
    [f"needle{i}" for i in range(30)],
    ["abc"],
    ["^start", "end$", "a|"],
    [r"[a-m]+X", r"[h-z]+Y", r"\d\d", "q"],
    ["panic:", "code=50[34]", "FATAL|CRIT", r"retry \d+/\d+", "^start"],
    bench.PATTERNS,
]
IDS = ["24x", "needles", "abc", "match_all", "clash", "cls", "bench"]


def leaves_of(prog) -> dict:
    return {k: np.asarray(getattr(prog, k)).astype(np.int64) for k in LEAVES}


def assert_same_program(tp, jdp):
    jl = leaves_of(jdp)
    for k in LEAVES:
        got = getattr(tp, k).numpy().astype(np.int64)
        assert got.shape == jl[k].shape, k
        assert np.array_equal(got, jl[k]), k
    for k in META:
        assert getattr(tp, k) == getattr(jdp, k), k
    assert tp.pattern_group == jdp.pattern_group


@pytest.mark.parametrize("ignore_case", [False, True], ids=["case", "nocase"])
@pytest.mark.parametrize("patterns", PATTERN_SETS, ids=IDS)
def test_compile_grouped_equals_jax(patterns, ignore_case):
    tp, live, acc = nfa.compile_grouped(patterns, ignore_case=ignore_case,
                                        device="cpu")
    jdp, jlive, jacc = jnfa.compile_grouped(patterns, ignore_case=ignore_case)
    assert (live, acc) == (jlive, jacc)
    assert_same_program(tp, jdp)
    assert tp.char_mask.dtype == tp.follow.dtype == torch.int8


@pytest.mark.parametrize("patterns", PATTERN_SETS, ids=IDS)
def test_augment_pack_equals_jax(patterns):
    tp = nfa.pack_program(nfa.augment(compile_patterns(patterns)),
                          device="cpu")
    jdp = jnfa.pack_program(jnfa.augment(jax_compile(patterns)),
                            dtype=jnp.int8)
    assert_same_program(tp, jdp)


def test_bench_set_shapes():
    """The 32-pattern main-path set: G=4 groups of S=128 states over C=64
    classes; its augmented union automaton is S=512."""
    tp, live, acc = nfa.compile_grouped(bench.PATTERNS, device="cpu")
    assert tuple(tp.follow.shape) == (4, 128, 128)
    assert (tp.n_classes, live, acc) == (64, 126, 127)
    union = compile_patterns(bench.PATTERNS)
    assert union.n_states == 400
    assert nfa.pack_program(nfa.augment(union), device="cpu").n_states == 512


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "union"])
def test_program_from_jax_round_trips(grouped):
    pats = ["panic:", r"retry \d+/\d+", "^start", "end$"]
    if grouped:
        jdp, _, _ = jnfa.compile_grouped(pats)
        mine, _, _ = nfa.compile_grouped(pats, device="cpu")
    else:
        jdp = jnfa.pack_program(jnfa.augment(jax_compile(pats)))
        mine = nfa.pack_program(nfa.augment(compile_patterns(pats)),
                                device="cpu")
    leaves = {k: np.asarray(getattr(jdp, k)) for k in LEAVES}
    meta = {k: getattr(jdp, k) for k in META + ("pattern_group",)}
    tp = nfa.program_from_jax(leaves, meta, device="cpu")
    assert_same_program(tp, jdp)
    for k in LEAVES:
        assert np.array_equal(getattr(tp, k).numpy(), getattr(mine, k).numpy())


def test_compile_grouped_rejects_empty():
    with pytest.raises(ValueError):
        nfa.compile_grouped([], device="cpu")


def test_resolve_device_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        nfa.resolve_device(None)
    assert nfa.resolve_device("cpu").type == "cpu"
