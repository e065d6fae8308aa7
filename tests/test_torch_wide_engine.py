"""``GpuEngineFilter`` on a set whose groups are past 32 words, on the
CPU: the 32 bench patterns and a watch list written as one alternation
(``chip_smoke.WATCH``, "the lines of any of these 128 pods"), 5 groups
of 1152 states. Short lines take K1's wide route and long lines K2g's
over the grouped automata (no union built, K2 never called); the
kernels' plain versions run here. Verdicts equal the JAX engine's
(``NFAEngineFilter(kernel="interpret")``: Pallas in interpret mode, its
long lines on the 1536-state union) and a ``re`` oracle. Inputs are
FakeCluster lines and long lines made with numpy from a seed; the long
lines' batch holds at most 8 rows (the MKL note in ``ROADMAP.md``)."""

import re

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from klogs_tpu.filters.tpu import NFAEngineFilter
from klogs_tpu_torch.cluster.fake import synthetic_line
from klogs_tpu_torch.filters.base import frame_lines
from klogs_tpu_torch.filters.gpu import GpuEngineFilter
from klogs_tpu_torch.ops import nfa_kernels

PATTERNS = list(bench.PATTERNS) + [chip_smoke.WATCH]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain step's batched products on one thread: several test
    processes each spreading them over every core slow each other to a
    crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def oracle(line: bytes) -> bool:
    body = line.rstrip(b"\n")
    return any(re.search(p.encode(), body) for p in PATTERNS)


def lines_of(seed: int) -> list:
    """96 FakeCluster lines of 48 pods (every other pod on the watch
    list; the 32 patterns match some too), a few lines written around
    the watch list, and 6 long lines of 4-8 KiB: watch needles inside a
    chunk, across the 4096-byte edge, ending on it, a near miss, and a
    bench needle."""
    rng = np.random.default_rng(seed)
    lines = [synthetic_line(f"pod-{i % 48:04d}", "c0", i, chip_smoke.CLOCK + i)
             for i in range(96)]
    lines += [b"pod=pod-0255", b"pod=pod-0256\n", b"x pod=pod-01", b"",
              b"pod=pod-0129 and panic: too"]
    for nd, at in ((b"pod=pod-0011", 1000), (b"pod=pod-0033", 4090),
                   (b"pod=pod-0077", 4096), (b"pod=pod-0012", 4500),
                   (b"oom-killer", 6000), (b"pod=pod-0201", None)):
        n = int(rng.integers(4097, 8 * 1024 + 1))
        body = bytearray(rng.integers(32, 127, size=n, dtype=np.uint8))
        end = n if at is None else at
        body[end - len(nd):end] = nd
        lines.append(bytes(body) + (b"\n" if at == 4500 else b""))
    return lines


def test_watch_list_engine_equals_jax_and_re(monkeypatch):
    """The set's groups are all 36 words; its union (1,428 states,
    padded to 1536) is past ``GROUPED_LONG_STATES``, so long lines take
    K2g over the grouped program and the union is never built. Through
    the list and the framed entries the verdicts are the JAX engine's
    and ``re``'s."""
    def no_union(*a, **kw):
        raise AssertionError("K2 on the grouped route")

    monkeypatch.setattr(nfa_kernels, "match_chunk_cls", no_union)
    port = GpuEngineFilter(PATTERNS, device="cpu")
    assert port._grouped.follow.shape[0] == 5
    assert nfa_kernels.grouped_state_words(port._grouped) == 36
    assert port._aug is None and port._long is not None
    assert port._long[0] is port._grouped
    lines = lines_of(33)
    got = port.match_lines(lines)
    want = [oracle(ln) for ln in lines]
    assert got == want
    assert any(want[:96]) and not all(want[:96])
    assert want[-6:] == [True, True, True, False, True, True]
    ref = NFAEngineFilter(PATTERNS, kernel="interpret")
    assert ref.match_lines(lines) == got
    payload, offsets, _ = frame_lines(lines[:96], strip_nl=False)
    framed = port.fetch_framed(port.dispatch_framed(payload, offsets))
    assert framed.tolist() == got[:96]
