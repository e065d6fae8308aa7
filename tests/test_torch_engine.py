"""GpuEngineFilter on the CPU (the kernels' plain versions) against the
JAX engine (``NFAEngineFilter(kernel="interpret")``: Pallas in interpret
mode) and a ``re`` oracle: short lines in several width buckets, long
lines (> chunk_bytes) through the carried-state path, a line over 128
KiB, include/exclude, and both the list and the framed entries."""

import re

import numpy as np
import pytest

from klogs_tpu.filters.base import IncludeExcludeFilter as JaxIncludeExclude
from klogs_tpu.filters.tpu import NFAEngineFilter
from klogs_tpu_torch.filters.base import build_include_exclude, frame_lines
from klogs_tpu_torch.filters.gpu import GpuEngineFilter

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
