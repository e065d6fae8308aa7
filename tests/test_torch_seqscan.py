"""The sequence-parallel scan for huge lines (``ops/seqscan.py``) on the
CPU, held against the JAX package's ``klogs_tpu/ops/seqscan.py`` on the
same seeded inputs: transfer matrices and final state vectors bit for
bit, verdicts of single lines, batches and lines sharded over several
devices verdict for verdict (and against ``re``), and the step-matrix
budget."""

import functools
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from klogs_tpu.filters.compiler.glushkov import compile_patterns as jax_compile
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu.ops import seqscan as jseq
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.ops import nfa, seqscan
from tests.test_seqscan import CASES

LEAVES = ("char_mask", "follow", "inject", "accept", "byte_class")
META = ("begin_class", "end_class", "pad_class", "n_classes", "n_states",
        "match_all")
ALPHABET = b"ab0 .xq-"
ATOMS = ["a", "b", "0", ".", "x", "ab", "[ab]", "[0-9]", "q+", "(?:a|x)",
         "b*"]


@pytest.fixture(autouse=True)
def one_thread():
    """The float products on one thread: several test processes each
    spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def oracle(patterns, line: bytes) -> bool:
    return any(re.search(p.encode(), line) for p in patterns)


def both(patterns):
    """(JAX's int8 augmented union program, the port's program carried
    from it, live, acc); the carried program equals the port's own."""
    prog = jax_compile(patterns)
    jdp = jnfa.pack_program(jnfa.augment(prog), dtype=np.int8)
    tp = nfa.program_from_jax({k: np.asarray(getattr(jdp, k)) for k in LEAVES},
                              {k: getattr(jdp, k) for k in META},
                              device="cpu")
    own = nfa.pack_program(nfa.augment(compile_patterns(patterns)),
                           device="cpu")
    for k in LEAVES:
        assert torch.equal(getattr(tp, k), getattr(own, k)), k
    for k in META:
        assert getattr(tp, k) == getattr(own, k), k
    return jdp, tp, prog.n_states, prog.n_states + 1


def random_set(rng, n: int) -> list:
    return ["".join(rng.choice(ATOMS) for _ in range(rng.randrange(1, 4)))
            for _ in range(n)]


def random_line(rng, n: int) -> bytes:
    return bytes(rng.choice(ALPHABET) for _ in range(n))


@pytest.mark.parametrize("patterns,line,expected", CASES,
                         ids=lambda v: repr(v)[:30])
def test_cases_equal_jax(patterns, line, expected):
    jdp, tp, live, acc = both(patterns)
    got = seqscan.match_line_scan(tp, live, acc, line, tile_t=128)
    assert got is expected
    assert got == jseq.match_line_scan(jdp, live, acc, line, tile_t=128)


@pytest.mark.parametrize("seed,tile_t", [(1, 8), (2, 8), (3, 64), (4, 64)])
def test_transfer_matrices_and_final_vectors_equal_jax(seed, tile_t):
    """On a seeded random set, classes of random lines (BEGIN, END, the
    latch and PAD included): ``tile_transfer_matrices`` and
    ``_scan_chunked``'s final state vectors, bit for bit."""
    rng = random.Random(seed)
    pats = random_set(rng, rng.randrange(1, 4))
    jdp, tp, live, acc = both(pats)
    line = random_line(rng, 6 * tile_t + rng.randrange(tile_t))
    cls = np.asarray(jseq.classify_line(jdp, line, tile_t), dtype=np.int32)
    assert np.array_equal(
        seqscan.classify_line(tp, line, tile_t).numpy(), cls)
    tiles = cls.reshape(-1, tile_t)
    want = np.asarray(jseq.tile_transfer_matrices(jdp, jnp.asarray(tiles)))
    got = seqscan.tile_transfer_matrices(tp, torch.from_numpy(tiles))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert want[:, live, live].all() and want.sum() > tiles.shape[0]
    # Chunks of 1, 2 and 4 tiles: the same final vector, JAX's.
    for tpc in (1, 2, 4):
        pad = -tiles.shape[0] % tpc
        cls3 = np.concatenate(
            [tiles, np.full((pad, tile_t), jdp.pad_class, np.int32)]
        ).reshape(-1, tpc, tile_t)
        want = np.asarray(jseq._scan_chunked(jdp, jnp.asarray(cls3), live))
        got = seqscan._scan_chunked(tp, torch.from_numpy(cls3), live)
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), want)
        assert bool(want[acc]) == oracle(pats, line)


def test_batched_lines_equal_jax_and_re(monkeypatch):
    """Mixed lines of 1-8 KiB in one call: verdicts equal JAX's and
    ``re``'s, a bool tensor on the device; one batched fold a chunk-count
    group."""
    pats = ["needle[0-9]", "END$", "^ab"]
    jdp, tp, live, acc = both(pats)
    rng = random.Random(11)
    lines = []
    for i in range(9):
        body = random_line(rng, rng.randrange(1024, 8 * 1024))
        if i % 3 == 0:
            cut = rng.randrange(len(body))
            body = body[:cut] + b"needle7" + body[cut:]
        if i % 4 == 0:
            body += b"END"
        if i == 5:
            body = b"ab" + body
        lines.append(body)
    calls = []
    real = seqscan._scan_chunked

    def spy(prog, cls, live_):
        calls.append(tuple(cls.shape))
        return real(prog, cls, live_)

    monkeypatch.setattr(seqscan, "_scan_chunked", spy)
    got = seqscan.match_lines_scan(tp, live, acc, lines, tile_t=128)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    exp = [oracle(pats, ln) for ln in lines]
    assert got.tolist() == exp
    assert exp == jseq.match_lines_scan(jdp, live, acc, lines, tile_t=128)
    assert any(exp) and not all(exp)
    # One fold a group: the chunk counts of the folds are distinct, powers
    # of two (a fold holds several lines), and their lines add up to the
    # call's.
    assert len({c[1] for c in calls}) == len(calls)
    assert all(c[1] & (c[1] - 1) == 0 for c in calls)
    assert sum(c[0] for c in calls) == len(lines)
    # Lines of one chunk count run as ONE fold.
    calls.clear()
    same = [random_line(rng, 3000) + b"needle1" * (i % 2) for i in range(8)]
    got = seqscan.match_lines_scan(tp, live, acc, same, tile_t=128)
    assert got.tolist() == [i % 2 == 1 for i in range(8)]
    assert len(calls) == 1 and calls[0][0] == 8


def test_match_all_shortcut(monkeypatch):
    jdp, tp, live, acc = both(["a|"])
    assert tp.match_all
    monkeypatch.setattr(seqscan, "_scan_chunked", None)  # never called
    assert seqscan.match_line_scan(tp, live, acc, b"zzz") is True
    got = seqscan.match_lines_scan(tp, live, acc, [b"zzz", b"", b"q" * 900])
    assert got.tolist() == [True] * 3
    assert jseq.match_lines_scan(jdp, live, acc, [b"zzz", b""]) == [True] * 2
    assert seqscan.match_lines_scan(tp, live, acc, []).tolist() == []


@pytest.mark.parametrize("case", [0, 4], ids=["needle", "end_anchor"])
def test_budget_forces_one_tile_a_chunk(monkeypatch, case):
    """A budget below one tile's step matrices: one tile a chunk (the
    floor), the verdicts unchanged; the anchor crosses chunks."""
    patterns, line, expected = CASES[case]
    jdp, tp, live, acc = both(patterns)
    runs = []
    real = seqscan._transfer

    def spy(prog, cls):
        runs.append(tuple(cls.shape))
        return real(prog, cls)

    monkeypatch.setattr(seqscan, "_transfer", spy)
    assert seqscan.match_line_scan(tp, live, acc, line, tile_t=128,
                                   step_bytes_budget=1 << 16) is expected
    assert {r[1] for r in runs} == {128}
    # A lone line's chunk count is not padded.
    assert len(runs) == -(-(len(line) + 3) // 128)
    assert jseq.match_line_scan(jdp, live, acc, line, tile_t=128,
                                step_bytes_budget=1 << 16) is expected


@pytest.mark.parametrize("budget", [2 << 20, 3 << 20, 8 << 20, 32 << 20])
def test_step_bytes_stay_within_the_budget(monkeypatch, budget):
    """Whenever one tile's step matrices fit the budget, no call of the
    tree materialises more than the budget (float32 on the CPU: 4 bytes
    an entry), however many lines run together; the verdicts are
    ``re``'s."""
    pats = ["needle", "ab0"]
    _, tp, live, acc = both(pats)
    S, tile_t = tp.n_states, 32
    assert tile_t * S * S * 4 <= budget
    peak = []
    real = seqscan._transfer

    def spy(prog, cls):
        peak.append(cls.numel() * S * S * 4)
        return real(prog, cls)

    monkeypatch.setattr(seqscan, "_transfer", spy)
    rng = random.Random(budget)
    lines = [random_line(rng, rng.randrange(200, 2500)) for _ in range(6)]
    lines[2] = lines[2][:100] + b"needle" + lines[2][100:]
    got = seqscan.match_lines_scan(tp, live, acc, lines, tile_t=tile_t,
                                   step_bytes_budget=budget)
    assert got.tolist() == [oracle(pats, ln) for ln in lines]
    assert peak and max(peak) <= budget


SHARDED_LINES = [(["needle"], b"x" * 20000 + b"needle" + b"y" * 20000, True),
                 (["needle"], b"x" * 40000, False)]


@functools.lru_cache(maxsize=None)
def jax_sharded(patterns: tuple, line: bytes, budget: int) -> bool:
    """JAX's verdict on its 8-device mesh (computed once for both device
    counts of the port)."""
    assert jax.device_count() == 8
    jdp, _, live, acc = both(list(patterns))
    return jseq.match_line_sharded(jdp, live, acc, line, tile_t=128,
                                   step_bytes_budget=budget)


@pytest.mark.parametrize("n_dev", [8, 3])
@pytest.mark.parametrize("patterns,line,expected", CASES[:6],
                         ids=lambda v: repr(v)[:30])
def test_sharded_equals_jax(patterns, line, expected, n_dev):
    _, tp, live, acc = both(patterns)
    got = seqscan.match_line_sharded(tp, live, acc, line,
                                     devices=["cpu"] * n_dev, tile_t=128)
    assert got is expected
    assert got == jax_sharded(tuple(patterns), line,
                              seqscan.DEFAULT_STEP_BYTES_BUDGET)


@pytest.mark.parametrize("n_dev", [8, 3])
def test_sharded_chunked_budget_equals_jax(n_dev):
    """JAX's ``test_sharded_chunked_budget`` lines: a budget of one tile
    a chunk over 8 and 3 devices, each span folded chunk by chunk."""
    _, tp, live, acc = both(["needle"])
    for _, line, expected in SHARDED_LINES:
        got = seqscan.match_line_sharded(tp, live, acc, line,
                                         devices=["cpu"] * n_dev, tile_t=128,
                                         step_bytes_budget=1 << 16)
        assert got is expected
        assert got == jax_sharded(("needle",), line, 1 << 16)


def test_sharded_default_devices_and_one_copy_a_device(monkeypatch):
    """``devices=None`` asks ``parallel.mesh.engine_devices`` for the
    program's device type; a program is copied to each distinct device
    once, into its cache."""
    from klogs_tpu_torch.parallel import mesh

    _, tp, live, acc = both(["needle"])
    asked = []
    monkeypatch.setattr(mesh, "engine_devices",
                        lambda device=None: asked.append(device) or
                        [torch.device("cpu")] * 2)
    line = b"x" * 3000 + b"needle"
    assert seqscan.match_line_sharded(tp, live, acc, line, tile_t=128)
    assert asked == ["cpu"]
    assert not [k for k in tp.cache if k[0] == "seqscan_on"]
    meta = torch.device("meta")
    moved = seqscan._on(tp, meta)
    assert moved.follow.device == meta and moved.cache == {}
    assert seqscan._on(tp, meta) is moved
    assert seqscan._on(tp, torch.device("cpu")) is tp


def test_engine_huge_lines_stay_on_the_chunk_path(monkeypatch):
    """JAX's ``test_engine_filter_concurrent_huge_lines`` on the port:
    with ``SEQ_SCAN_BYTES`` at 8 KB, four 12 KB lines beside short ones
    get the JAX engine's verdicts (its huge lines through its seq-scan)
    and ``re``'s, and here run the chunk path: the tree lost to K2 on
    the card, so the engine never calls it."""
    from klogs_tpu.filters.cpu import RegexFilter
    from klogs_tpu.filters.tpu import NFAEngineFilter
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter

    pats = ["boom!", "ok$"]
    rng = random.Random(5)
    huge = [bytes(rng.choice(b"qwerty ") for _ in range(12_000))
            for _ in range(4)]
    huge[1] = huge[1][:6000] + b"boom!" + huge[1][6000:]
    lines = [b"small boom!", b"tiny ok"] + huge
    ref = NFAEngineFilter(pats, kernel="interpret")
    monkeypatch.setattr(ref, "SEQ_SCAN_BYTES", 8192)
    jax_huge = []
    real_huge = ref._match_huge
    monkeypatch.setattr(ref, "_match_huge",
                        lambda bodies: jax_huge.append(len(bodies))
                        or real_huge(bodies))
    port = GpuEngineFilter(pats, device="cpu")
    monkeypatch.setattr(port, "SEQ_SCAN_BYTES", 8192)
    long_rows = []
    real_long = port._match_long
    monkeypatch.setattr(port, "_match_long",
                        lambda p, s, n, longest: long_rows.append(longest)
                        or real_long(p, s, n, longest))

    def refused(*a, **kw):
        raise AssertionError("the engine called the seq-scan")

    for name in ("match_lines_scan", "_scan_chunked", "_transfer"):
        monkeypatch.setattr(seqscan, name, refused)
    got = port.match_lines(lines)
    assert got == ref.match_lines(lines)
    assert got == RegexFilter(pats).match_lines(lines)
    assert got == [True, True, False, True, False, False]
    assert jax_huge == [4]
    assert long_rows == [max(map(len, huge))]
