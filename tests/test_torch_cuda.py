"""CUDA kernels against their plain versions, on the card.

These need a CUDA device and nvcc; elsewhere they skip. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.filters.gpu import GpuEngineFilter
from klogs_tpu_torch.ops import nfa, nfa_kernels

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
    return torch.from_numpy(cls.astype(np.int16))


@pytest.mark.parametrize("patterns", [
    PATTERNS,
    ["a" * 200 + "b", r"x\d+y"],  # a 256-state group
    ["q" * 600 + "z", "panic:"],  # 640 states, run padded to 1024
    ["q" * 1100 + "z", "panic:"],  # a group wider than 1024 states
], ids=["s128", "s256", "s640", "wide"])
def test_grouped_kernel_equals_plain(dev, patterns):
    prog, live, acc = nfa.compile_grouped(patterns, device=dev)
    for B, T in ((1, 5), (130, 67), (1000, 300)):
        cls = random_cls(prog, B, T, B).to(dev)
        got = nfa_kernels.match_cls_grouped(prog, live, acc, cls)
        exp = nfa_kernels.match_cls_grouped_plain(prog, live, acc, cls)
        assert torch.equal(got, exp)


@pytest.mark.parametrize("patterns", [
    PATTERNS, ["q" * 600 + "z", "panic:"], ["w" * 1100 + "k", "EPIPE"],
], ids=["s128", "s640", "wide"])
def test_chunk_kernel_equals_plain_chained(dev, patterns):
    union = compile_patterns(patterns)
    prog = nfa.pack_program(nfa.augment(union), device=dev)
    live, acc = union.n_states, union.n_states + 1
    B = 70
    v = nfa_kernels.initial_state(prog, live, B)
    vp = v.clone()
    for k in range(3):
        cls = random_cls(prog, B, 129, k).to(dev)
        v, m = nfa_kernels.match_chunk_cls(prog, acc, cls, v, final=k == 2)
        vp, mp = nfa_kernels.match_chunk_cls_plain(prog, acc, cls, vp)
        assert torch.equal(v, vp) and torch.equal(m, mp)


def test_kernels_count_launches(dev):
    prog, live, acc = nfa.compile_grouped(PATTERNS, device=dev)
    nfa_kernels.reset_launches()
    nfa_kernels.match_cls_grouped(prog, live, acc, random_cls(prog, 8, 9, 0).to(dev))
    assert nfa_kernels.LAUNCHES[nfa_kernels.GROUPED] == 1


def test_engine_on_card_equals_cpu(dev):
    rng = np.random.default_rng(9)
    lines = [rng.integers(32, 127, size=int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 9000, size=300)]
    lines += [b"panic: now", b"start", b"the end", b"x" * 5000 + b"code=503",
              b"y" * (140 * 1024) + b"FATAL code=1"]
    gpu = GpuEngineFilter(PATTERNS, device=dev).match_lines(lines)
    cpu = GpuEngineFilter(PATTERNS, device="cpu").match_lines(lines)
    assert gpu == cpu
    assert sum(gpu) >= 5
