"""GpuEngineFilter on the CPU (the kernels' plain versions) against the
JAX engine (``NFAEngineFilter(kernel="interpret")``: Pallas in interpret
mode) and a ``re`` oracle: short lines in several width buckets, long
lines (> chunk_bytes) through the carried-state path, a line over 128
KiB, include/exclude, and both the list and the framed entries."""

import re

import numpy as np
import pytest
import torch

import bench
from klogs_tpu.filters.base import IncludeExcludeFilter as JaxIncludeExclude
from klogs_tpu.filters.tpu import NFAEngineFilter
from klogs_tpu_torch.filters.base import build_include_exclude, frame_lines
from klogs_tpu_torch.filters.gpu import GpuEngineFilter


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PATTERNS = ["panic:", r"retry \d+/\d+", "code=50[34]", "^start", "end$",
            r"(?:FATAL|CRIT).*code=\d+"]
CHUNK = 256


def oracle(patterns, line: bytes) -> bool:
    body = line.rstrip(b"\n")
    return any(re.search(p.encode(), body) for p in patterns)


def corpus(seed: int = 5) -> list[bytes]:
    rng = np.random.default_rng(seed)
    needles = [b"panic:", b"retry 4/9", b"code=503", b"FATAL at code=7",
               b"start", b"end"]
    lines = [b"", b"\n", b"start here\n", b"not at the end", b"the end\n\n",
             b"code=503", b"code=502", b"end\nx"[:3]]
    for i in range(40):
        n = int(rng.integers(0, 3 * CHUNK))
        body = bytearray(rng.integers(32, 127, size=n).astype(np.uint8))
        if i % 3 == 0 and n > 20:
            nd = needles[i % len(needles)]
            p = int(rng.integers(0, n - len(nd)))
            body[p:p + len(nd)] = nd
        lines.append(bytes(body) + (b"\n" if i % 2 else b""))
    # Exactly chunk_bytes, one over, a needle across a chunk edge, and
    # END landing on a chunk edge.
    lines.append(b"a" * CHUNK)
    lines.append(b"a" * (CHUNK - 3) + b"panic:")
    lines.append(b"b" * (2 * CHUNK - 3) + b"end")
    lines.append(b"c" * (2 * CHUNK - 2) + b"retry 1/2")
    return lines


@pytest.fixture(scope="module")
def engines():
    return (GpuEngineFilter(PATTERNS, chunk_bytes=CHUNK, device="cpu"),
            NFAEngineFilter(PATTERNS, chunk_bytes=CHUNK, kernel="interpret"))


def test_list_entry_equals_jax_and_oracle(engines):
    port, ref = engines
    lines = corpus()
    got = port.match_lines(lines)
    assert got == ref.match_lines(lines)
    assert got == [oracle(PATTERNS, ln) for ln in lines]
    assert any(got) and not all(got)


def test_framed_entry_equals_list_entry(engines):
    port, ref = engines
    lines = corpus(6)
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    got = port.fetch_framed(port.dispatch_framed(payload, offsets))
    assert got.dtype == bool
    assert got.tolist() == port.match_lines(lines)
    exp = ref.fetch_framed(ref.dispatch_framed(payload, offsets))
    assert got.tolist() == np.asarray(exp).tolist()


def test_line_over_seq_scan_bytes():
    """A line past SEQ_SCAN_BYTES (the JAX engine's sequence-parallel
    scan) runs the chunk path here with the same verdict."""
    pats = ["needle", "^x+$"]
    port = GpuEngineFilter(pats, chunk_bytes=4096, device="cpu")
    huge = b"x" * (GpuEngineFilter.SEQ_SCAN_BYTES + 700)
    lines = [huge, huge[:-1] + b"y", b"y" * 5000 + b"needle", b"short needle"]
    got = port.match_lines(lines)
    assert got == [True, False, True, True]
    assert got == NFAEngineFilter(pats, kernel="interpret").match_lines(lines)


def test_include_exclude_equals_jax():
    inc, exc = ["code=50[0-9]", "panic:"], [r"code=503", "quiet"]
    lines = [b"code=500", b"code=503", b"panic: quiet", b"panic: loud",
             b"nothing", b"code=504 " + b"z" * 600]
    port = build_include_exclude(
        lambda p: GpuEngineFilter(p, chunk_bytes=CHUNK, device="cpu"),
        inc, exc)
    ref = JaxIncludeExclude(NFAEngineFilter(inc, kernel="interpret"),
                            NFAEngineFilter(exc, kernel="interpret"))
    exp = [oracle(inc, ln) and not oracle(exc, ln) for ln in lines]
    assert port.match_lines(lines) == ref.match_lines(lines) == exp
    payload, offsets, _ = frame_lines(lines)
    assert port.fetch_framed(port.dispatch_framed(payload, offsets)).tolist() == exp
    only_exc = build_include_exclude(
        lambda p: GpuEngineFilter(p, device="cpu"), [], exc)
    assert only_exc.match_lines(lines) == [not oracle(exc, ln) for ln in lines]


def test_match_all_and_empty_batches():
    port = GpuEngineFilter(["a|", "x"], device="cpu")
    assert port.match_lines([b"", b"zzz"]) == [True, True]
    assert port.match_lines([]) == []
    empty = np.zeros(1, dtype=np.int32)
    assert port.fetch_framed(port.dispatch_framed(b"", empty)).tolist() == []


def test_width_buckets_clamp_to_chunk_bytes():
    port = GpuEngineFilter(["x"], chunk_bytes=300, device="cpu")
    lens = np.array([0, 128, 129, 256, 257, 300])
    widths = port._width_buckets(lens, lens <= 300, len(lens))
    assert widths.tolist() == [128, 128, 256, 256, 300, 300]


def test_cuda_device_raises_without_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        GpuEngineFilter(["x"], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        GpuEngineFilter(["x"])


# ---- the thousand-pattern gates ------------------------------------------

K64 = bench.make_patterns(64)


def k64_lines() -> list[bytes]:
    lines = [ln for ln in bench.make_lines(40)]
    lines += [b"svc-0008 unreachable\n", b"errcode=00009", b"CRIT00011 x",
              b"x tenant-0010 y quota exceeded", b"svc-0001 unreachable",
              b"PANIC job-00014", b"user=u000015 denied\n", b"", b"panic: a",
              b"retry 3/5", b"z" * 300 + b" deploy/rel-0013 failed"]
    return lines


@pytest.mark.parametrize("env", [{"KLOGS_TPU_SWEEP": "1"},
                                 {"KLOGS_TPU_PREFILTER": "1"}],
                         ids=["sweep", "prefilter"])
def test_gated_engine_equals_jax_and_oracle(env, monkeypatch):
    """Both engines gated the same way (the port's K3 plain version, the
    JAX gated Pallas kernel in interpret mode) give the oracle's
    verdicts, and the port records what the gate let through."""
    from klogs_tpu_torch.filters.base import FilterStats

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    stats = FilterStats()
    port = GpuEngineFilter(K64, chunk_bytes=CHUNK, device="cpu", stats=stats)
    ref = NFAEngineFilter(K64, chunk_bytes=CHUNK, kernel="interpret")
    swept = "KLOGS_TPU_SWEEP" in env
    assert (port._sweep_tables is not None) == swept
    assert (port._pf_tables is not None) == (not swept)
    assert (ref._sweep_tables is not None) == swept
    lines = k64_lines()
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    got = port.fetch_framed(port.dispatch_framed(payload, offsets)).tolist()
    exp = [oracle(K64, ln) for ln in lines]
    assert got == exp and sum(exp) >= 8
    assert ref.match_lines(lines) == exp
    n_short = sum(len(ln.rstrip(b"\n")) <= CHUNK for ln in lines)
    assert stats.pf_lines == n_short
    assert 0 < stats.pf_candidates <= n_short
    assert 0 < stats.pf_tiles_live <= stats.pf_tiles_total
    assert stats.sweep_lines == (n_short if swept else 0)


def test_gate_rules(monkeypatch):
    """Auto keeps the sweep off on the CPU; KLOGS_INDEX_MIN_K moves the
    threshold of the cuda rule; a forced sweep beats the prefilter; a
    malformed KLOGS_TPU_SWEEP raises."""
    import torch

    from klogs_tpu_torch.filters import cpu

    cuda, host = torch.device("cuda"), torch.device("cpu")
    monkeypatch.delenv("KLOGS_TPU_SWEEP", raising=False)
    monkeypatch.delenv("KLOGS_INDEX_MIN_K", raising=False)
    assert GpuEngineFilter(K64, device="cpu")._sweep_tables is None
    assert not cpu.device_sweep_wanted(1024, host)
    assert cpu.device_sweep_wanted(64, cuda)
    assert not cpu.device_sweep_wanted(63, cuda)
    monkeypatch.setenv("KLOGS_INDEX_MIN_K", "10")
    assert cpu.index_min_k() == 10 and cpu.device_sweep_wanted(10, cuda)
    monkeypatch.setenv("KLOGS_INDEX_MIN_K", "junk")
    assert cpu.index_min_k() == cpu.INDEX_MIN_K
    assert cpu.device_gate_choice(100, True, cuda) == "prefilter"
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "1")
    assert cpu.device_gate_choice(2, True, host) == "sweep"
    monkeypatch.setenv("KLOGS_TPU_PREFILTER", "1")
    both = GpuEngineFilter(["panic:", "code=50[34]"], device="cpu")
    assert both._sweep_tables is not None and both._pf_tables is None
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "0")
    assert cpu.device_gate_choice(1024, False, cuda) == "off"
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "bogus")
    with pytest.raises(ValueError, match="KLOGS_TPU_SWEEP"):
        GpuEngineFilter(["x"], device="cpu")


def test_unusable_prefilter_says_why(monkeypatch):
    from klogs_tpu_torch.filters.base import FilterStats

    monkeypatch.setenv("KLOGS_TPU_PREFILTER", "1")
    stats = FilterStats()
    eng = GpuEngineFilter(["panic:", "a.*"], device="cpu", stats=stats)
    assert eng._pf_tables is None
    assert "prefilter disabled" in stats.pf_disabled_reason
    assert "'a.*'" in stats.pf_disabled_reason
    assert eng.match_lines([b"panic: x", b"b"]) == [True, False]
    assert stats.pf_lines == 0
