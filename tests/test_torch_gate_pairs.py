"""K3's pair list: the plain ``gate_pairs`` against numpy's nonzero of
the unpacked gate, in the kernel's order (group-major, lines
ascending), with its count and the gate's stats. Exact equality."""

import numpy as np
import pytest
import torch

from klogs_tpu_torch.ops import bits, nfa_kernels


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_pairs(words: np.ndarray, G: int):
    """(g * B + b for every set bit g < G of line b's [GW] words, in
    group-major order, lines ascending; the lines with any such bit)."""
    g = np.arange(G)
    cells = (words[:, g // 32] >> (g % 32)) & 1  # [B, G]
    return np.nonzero(cells.T.reshape(-1))[0], int(cells.any(axis=1).sum())


def gate(B: int, G: int, share: float, seed: int, stray: bool = False):
    """[B, ceil(G/32)] int64 words of a seeded random gate; with
    ``stray``, every bit at or past G of the last word set too."""
    rng = np.random.default_rng(seed)
    words = bits.pack_bits(torch.from_numpy(rng.random((B, G)) < share))
    if stray and G % 32:
        words[:, -1] |= (0xFFFFFFFF << (G % 32)) & 0xFFFFFFFF
    return words


@pytest.mark.parametrize("B,G,share,stray", [
    (45, 37, 0.3, True),  # B, G not multiples of 32; bits past G set
    (300, 64, 0.1, False),  # two full words
    (70, 5, 0.0, True),  # empty gate (only stray bits)
    (33, 40, 1.0, True),  # all ones
    (1, 3, 0.7, False),  # one line
    (600, 156, 0.05, False),  # the 1024-pattern program's groups, 3 slabs
], ids=["ragged", "two_words", "empty", "all_ones", "one_line", "k1024"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_plain_pairs_equal_numpy(B, G, share, stray, dtype):
    words = gate(B, G, share, B + G, stray)
    if dtype == torch.int32:
        words = bits.to_int32(words)
    pairs, n_pairs, stats = nfa_kernels.gate_pairs(words, G)
    exp, n_cand = numpy_pairs((words.long() & 0xFFFFFFFF).numpy(), G)
    assert pairs.dtype == n_pairs.dtype == torch.int32
    assert pairs.shape == (B * G,) and n_pairs.shape == (1,)
    n = int(n_pairs)
    assert n == len(exp)
    assert pairs[:n].tolist() == exp.tolist()
    # Group-major, lines ascending: the list is sorted.
    assert np.all(np.diff(exp) > 0)
    assert stats.dtype == torch.int64
    assert stats.tolist() == [n_cand, -(-n_cand // nfa_kernels.GATE_TILE),
                              -(-B // nfa_kernels.GATE_TILE)]
    if share == 0.0:
        assert n == 0 and stats.tolist()[:2] == [0, 0]
    if share == 1.0:
        assert n == B * G


def test_plain_pairs_of_no_lines():
    pairs, n_pairs, stats = nfa_kernels.gate_pairs(
        torch.zeros((0, 2), dtype=torch.int64), 40)
    assert pairs.shape == (0,) and int(n_pairs) == 0
    assert stats.tolist() == [0, 0, 0]


def test_gate_pairs_reject_bad_gates():
    with pytest.raises(ValueError, match="gate_bits"):
        nfa_kernels.gate_pairs(torch.zeros((4, 2), dtype=torch.int64), 30)
    with pytest.raises(TypeError, match="gate_bits"):
        nfa_kernels.gate_pairs(torch.zeros((4, 1), dtype=torch.uint8), 30)
