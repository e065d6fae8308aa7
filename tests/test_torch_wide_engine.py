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


# ---- the thousand-pattern path with a wide group -------------------------

K64W = bench.make_patterns(64) + [chip_smoke.WATCH]
CHUNK = 256


def k64w_lines() -> list:
    """The port's K64 engine corpus (``bench.make_lines(40)``, minted
    needles, a 300-byte line: long at a 256-byte chunk) and lines around
    the watch list: 59 short lines and one long."""
    lines = list(bench.make_lines(40))
    lines += [b"svc-0008 unreachable\n", b"errcode=00009", b"CRIT00011 x",
              b"x tenant-0010 y quota exceeded", b"svc-0001 unreachable",
              b"PANIC job-00014", b"user=u000015 denied\n", b"", b"panic: a",
              b"retry 3/5", b"z" * 300 + b" deploy/rel-0013 failed"]
    lines += [b"pod=pod-0001", b"x pod=pod-0255 y\n", b"pod=pod-0002",
              b"pod=pod-013", b"pod=pod-0129 svc-0003 unreachable",
              b"pod=pod-0127 errcode=00011", b"pod=pod-0256", b"pod=pod-"]
    return lines


def test_k64_watch_engine_equals_jax_and_re(monkeypatch):
    """``make_patterns(64)`` and the watch list, 10 groups of 36 words,
    under the sweep gate: short lines go through the gated wrapper (K3,
    whose card kernel at this width is ``grouped_gated_wide_kernel``),
    never K1, and the long line through K2g; the verdicts equal the JAX
    engine's (sweep and gated Pallas kernel in interpret mode) and
    ``re``'s."""
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "1")
    gated, widths = nfa_kernels.match_cls_grouped_gated, []

    def recording(prog, live, acc, cls, words, want_stats=False):
        widths.append(nfa_kernels.kernel_states(prog.n_states) // 32)
        return gated(prog, live, acc, cls, words, want_stats=want_stats)

    def k1(*a, **kw):
        raise AssertionError("K1 ran under the sweep gate")

    monkeypatch.setattr(nfa_kernels, "match_cls_grouped_gated", recording)
    monkeypatch.setattr(nfa_kernels, "match_cls_grouped", k1)
    port = GpuEngineFilter(K64W, chunk_bytes=CHUNK, device="cpu")
    ref = NFAEngineFilter(K64W, chunk_bytes=CHUNK, kernel="interpret")
    assert port._sweep_tables is not None and ref._sweep_tables is not None
    assert port._grouped.follow.shape[0] == 10
    assert port._aug is None and port._long is not None
    lines = k64w_lines()
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    got = port.fetch_framed(port.dispatch_framed(payload, offsets)).tolist()
    exp = [any(re.search(p.encode(), ln.rstrip(b"\n")) for p in K64W)
           for ln in lines]
    assert got == exp and sum(exp) >= 12 and not all(exp)
    assert got[-8:] == [True, True, False, False, True, True, False, False]
    assert ref.match_lines(lines) == exp
    assert widths and set(widths) == {36}


# ---- past 160 words: the shared-memory route ------------------------------

# A 700-pod watch list (5,604 positions, under a raised position cap) and
# two bench patterns: 2 groups of 5632 states, 176 words, past 160.
SMEM_PATS = [chip_smoke.WATCH700, "panic:", r"retry \d+/\d+"]
SMEM_CHUNK = 64


def smem_lines() -> list:
    """Short lines around the 700-pod list (pods on it, off it, cut
    short, past its last pod) and 4 lines longer than the 64-byte chunk:
    a needle across the chunk edge, one ending on it, a near miss, a
    bench needle."""
    lines = [b"pod=pod-%04d x" % i for i in range(0, 1500, 97)]
    lines += [b"pod=pod-1399", b"pod=pod-1401\n", b"x pod=pod-07", b"",
              b"retry 3/5 pod=pod-0002"]
    lines += [b"z" * 60 + b" pod=pod-0011 q", b"q" * 52 + b"pod=pod-1397",
              b"y" * 70 + b"pod=pod-0640\n", b"panic: " + b"y" * 70]
    return lines


def smem_oracle(line: bytes) -> bool:
    return any(re.search(p.encode(), line.rstrip(b"\n")) for p in SMEM_PATS)


def test_watch700_engine_equals_jax_and_re(monkeypatch):
    """Past 160 words (``SMEM_PATS``: 2 groups of 176 words) short lines
    take K1's route and long lines K2g's (no union built), and the
    verdicts equal ``re``'s and the JAX engine's
    (``NFAEngineFilter(kernel="interpret")``, its long lines on the
    5,700-state union). Sized for the CPU: 21 short lines and 4 long
    ones at a 64-byte chunk took the port's plain versions 7.9 s and the
    JAX engine 4.6 s on one core (a 5632-state step reads a 254 MB float
    table a step; 4096-byte chunks and the 32 bench patterns cost the
    JAX side alone 33 s)."""
    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    port = GpuEngineFilter(SMEM_PATS, chunk_bytes=SMEM_CHUNK, device="cpu")
    assert nfa_kernels.grouped_state_words(port._grouped) == 176
    assert port._aug is None and port._long is not None
    lines = smem_lines()
    got = port.match_lines(lines)
    want = [smem_oracle(ln) for ln in lines]
    assert got == want
    assert any(want[:21]) and not all(want[:21])
    assert want[-4:] == [True, True, False, True]
    ref = NFAEngineFilter(SMEM_PATS, chunk_bytes=SMEM_CHUNK,
                          kernel="interpret")
    assert ref.match_lines(lines) == got


def test_watch700_long_lines_take_k2g(monkeypatch):
    """Long lines of a set past 160 words run K2g over the grouped
    automata at 176 words, a chunk at a time, the carry chained: the
    union is never built (``_aug`` is None) and K2 is never called."""
    monkeypatch.setenv("KLOGS_MAX_PATTERN_POSITIONS", "65536")
    widths = []
    grouped = nfa_kernels.match_chunk_cls_grouped

    def recording(prog, live, acc, cls, v0, final=True):
        widths.append(nfa_kernels.grouped_state_words(prog))
        return grouped(prog, live, acc, cls, v0, final=final)

    def no_union(*a, **kw):
        raise AssertionError("K2 on a set past 160 words")

    monkeypatch.setattr(nfa_kernels, "match_chunk_cls_grouped", recording)
    monkeypatch.setattr(nfa_kernels, "match_chunk_cls", no_union)
    port = GpuEngineFilter(SMEM_PATS, chunk_bytes=SMEM_CHUNK, device="cpu")
    assert port._aug is None and port._long[0] is port._grouped
    lines = smem_lines()[-4:]
    assert port.match_lines(lines) == [smem_oracle(ln) for ln in lines]
    assert widths == [176, 176]  # two chunks of the 4 long lines
