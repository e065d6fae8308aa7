"""The ragged pack (``ops/pack.py``) and the engine's framing on the
device, on the CPU: ``pack_rows_plain`` against the JAX package's numpy
scatter (``pack_framed_rows``), against the C packer the JAX engine
feeds its kernels (``hostops.pack_classify_framed``, compared after
``classify_chunk``) and against the JAX long-line path's chunk cuts;
then ``GpuEngineFilter.dispatch_framed`` against the JAX engine (Pallas
in interpret mode) and a ``re`` oracle on every path of the short rows.
Inputs are made from seeds with numpy."""

import re

import numpy as np
import pytest
import torch

from klogs_tpu.filters import base as jbase
from klogs_tpu.filters.tpu import NFAEngineFilter
from klogs_tpu.native import hostops
from klogs_tpu_torch.filters import base
from klogs_tpu_torch.filters.gpu import (GpuEngineFilter, _bucket_batch,
                                         strip_newlines)
from klogs_tpu_torch.ops import nfa, nfa_kernels, pack

PATTERNS = ["panic:", r"retry \d+/\d+", "code=50[34]", "^start", "end$",
            r"(?:FATAL|CRIT).*code=\d+"]
CHUNK = 4096


def random_lines(seed: int, n: int, longest: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = rng.integers(32, 127, size=int(rng.integers(0, longest)),
                            dtype=np.uint8).tobytes()
        out.append(body + b"\n" * int(rng.integers(0, 3)))
    return out


# The packer's edge cases, each a list of raw lines (newlines kept in
# the payload, as the sinks frame them).
CASES = {
    "zero_length": [b"", b"", b"abc\n", b"", b"x"],
    "only_newlines": [b"\n", b"\n\n\n", b"x\n", b"\n", b"\n\n"],
    "trailing_runs": [b"panic: a\n\n\n", b"d\n", b"end\n\n", b"z" * 127
                      + b"\n\n", b"y" * 300 + b"\n\n\n\n"],
    "exact_widths": [b"a" * w + b"\n" * (w % 3) for w in
                     (127, 128, 129, 255, 256, 257, 4095, 4096)],
    "exact_chunks": [b"b" * (k * CHUNK) + b"\n" * (k % 2) for k in (1, 2, 3)]
    + [b"c" * (2 * CHUNK + 1), b"d" * (CHUNK + 1) + b"\n"],
    "no_final_newline": [b"a\n", b"bb\n", b"code=503 " * 40 + b"\n",
                         b"ccc"],
    "random": random_lines(7, 60, 600) + random_lines(8, 6, 3 * CHUNK),
}


def framed(lines: list[bytes]):
    """(payload bytes, int32 offsets, payload tensor, stripped starts and
    lengths) of raw lines."""
    payload, offsets, _ = base.frame_lines(lines, strip_nl=False)
    starts, ends = strip_newlines(payload, offsets)
    pt = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
    return payload, offsets, pt, starts, ends - starts


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))


@pytest.mark.parametrize("width", [128, 256, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_rows_plain_equals_jax_scatter(case, width):
    """Every row that fits ``width``, at the bucket's rows, at exactly
    its count and at many more rows, against the JAX package's
    ``pack_framed_rows``; a reversed subset too."""
    payload, offsets, pt, starts, lens = framed(CASES[case])
    fit = np.nonzero(lens <= width)[0]
    for sel in (fit, fit[::-2]):
        for rows in sorted({len(sel), _bucket_batch(len(sel)),
                            len(sel) + 37}):
            got = pack.pack_rows(pt, t64(starts[sel]), t64(lens[sel]),
                                 width, rows)
            exp, exp_lens = jbase.pack_framed_rows(
                payload, offsets, width, rows=rows, sel=sel, lens=lens[sel])
            assert got.dtype == torch.uint8 and got.shape == (rows, width)
            assert np.array_equal(got.numpy(), exp)
            assert np.array_equal(exp_lens, lens[sel])


def test_pack_rows_empty_bucket_and_clamp():
    """No lines: rows of zeros; a line longer than the width is cut at
    it; ``skip`` past a line's end leaves its row zero."""
    pt = torch.arange(1, 41, dtype=torch.uint8)
    none = torch.zeros(0, dtype=torch.int64)
    assert not pack.pack_rows(pt, none, none, 128, 8).any()
    assert pack.pack_rows(pt, none, none, 128, 0).shape == (0, 128)
    got = pack.pack_rows(pt, t64([0, 10, 30]), t64([40, 5, 10]), 8, 4,
                         skip=3)
    assert got.tolist() == [list(range(4, 12)), [14, 15] + [0] * 6,
                            list(range(34, 41)) + [0], [0] * 8]
    with pytest.raises(ValueError):
        pack.pack_rows(pt, t64([0, 1]), t64([1, 1]), 8, 1)
    with pytest.raises(TypeError):
        pack.pack_rows(pt, t64([0]).int(), t64([1]), 8, 1)


def framed_cls_args(offsets, lens_raw, chunk: int):
    """The JAX engine's cls hot path (``tpu.py`` ``_dispatch_framed_cls``):
    width buckets of the raw lengths, each bucket's int32 ``sel`` and
    rows."""
    eng = GpuEngineFilter(["x"], chunk_bytes=chunk, device="cpu")
    short = lens_raw <= chunk
    width_of = eng._width_buckets(lens_raw, short, len(lens_raw))
    for w in np.unique(width_of[short]):
        sel = np.nonzero(short & (width_of == w))[0].astype(np.int32)
        yield int(w), sel, _bucket_batch(len(sel))


@pytest.mark.parametrize("case", sorted(CASES))
def test_classified_rows_equal_c_packer(case):
    """``classify_chunk`` of the packed rows equals the C framed
    packer's class ids (its rows classified on the host) bucket by
    bucket, with the JAX engine's arguments."""
    if hostops is None or not hasattr(hostops, "pack_classify_framed"):
        pytest.skip("the JAX package's C module is not built here")
    prog, _, _ = nfa.compile_grouped(PATTERNS, device="cpu")
    if prog.n_classes > 127:
        pytest.skip("the C packer takes at most 127 classes")
    tab = prog.byte_class.numpy().astype(np.int8).tobytes()
    payload, offsets, pt, starts, lens = framed(CASES[case])
    n_buckets = 0
    # A chunk wide enough that every line of every case has a bucket.
    for w, sel, rows in framed_cls_args(offsets, np.diff(offsets),
                                        4 * CHUNK):
        exp, _ = hostops.pack_classify_framed(
            payload, offsets, len(offsets) - 1, sel.tobytes(), w, rows, tab,
            prog.begin_class, prog.end_class, prog.pad_class)
        exp = np.frombuffer(exp, dtype=np.int8).reshape(rows, w + 3).copy()
        lens_p = np.zeros(rows, dtype=np.int64)
        lens_p[:len(sel)] = lens[sel]
        batch = pack.pack_rows(pt, t64(starts[sel]), t64(lens[sel]), w, rows)
        got = nfa.classify_chunk(prog, batch, t64(lens_p), first=True,
                                 final=True)
        assert torch.equal(got, torch.from_numpy(exp).to(torch.int16))
        n_buckets += 1
    assert n_buckets >= 1


@pytest.mark.parametrize("case,L", [
    ("exact_chunks", 256), ("exact_chunks", CHUNK), ("exact_widths", 256),
    ("trailing_runs", 256), ("random", 256), ("random", CHUNK)])
def test_chunk_cuts_equal_jax_long_path(case, L):
    """Chunk k of the long lines (``skip = k * L``) equals the JAX
    engine's ``b[k*L:(k+1)*L].ljust(L, b"\\0")`` of each stripped body,
    padding rows zero, for every k."""
    payload, offsets, pt, starts, lens = framed(CASES[case])
    rest = np.nonzero(lens > L)[0]
    assert len(rest)
    bodies = [payload[starts[i]:starts[i] + lens[i]] for i in rest]
    B = _bucket_batch(len(rest))
    for k in range(-(-int(lens[rest].max()) // L)):
        seg = [b[k * L:(k + 1) * L].ljust(L, b"\0") for b in bodies]
        exp = np.frombuffer(b"".join(seg + [b"\0" * L] * (B - len(rest))),
                            dtype=np.uint8).reshape(B, L)
        got = pack.pack_rows(pt, t64(starts[rest]), t64(lens[rest]), L, B,
                             skip=k * L)
        assert np.array_equal(got.numpy(), exp)


def test_engine_stages_metadata_and_payload_once():
    """``_layout`` + ``_stage``: one buffer holds every sub-batch's starts
    and lengths (zero-padded to its rows) and the payload, bucket by
    bucket in width order, then the long lines."""
    eng = GpuEngineFilter(PATTERNS, chunk_bytes=CHUNK, device="cpu")
    payload, offsets, _, starts, lens = framed(CASES["random"])
    layout, meta = eng._layout(payload, offsets)
    widths = [w for _, w, _, _ in layout]
    assert widths[:-1] == sorted(widths[:-1]) and widths[-1] is None
    assert sorted(np.concatenate([idx for idx, _, _, _ in layout])) == \
        list(range(len(lens)))
    meta_d, payload_d = eng._stage(payload, meta)
    assert meta_d.dtype == torch.int64
    assert np.array_equal(meta_d.numpy(), meta)
    assert payload_d.numpy().tobytes() == payload
    at = 0
    for idx, w, rows, longest in layout:
        assert rows == _bucket_batch(len(idx))
        assert np.array_equal(meta[at:at + len(idx)], starts[idx])
        assert np.array_equal(meta[at + rows:at + rows + len(idx)],
                              lens[idx])
        assert not meta[at + len(idx):at + rows].any()
        assert longest == lens[idx].max()
        at += 2 * rows
    assert at == len(meta)


def test_dispatch_runs_no_host_scatter(monkeypatch):
    """The engine's dispatch calls neither the numpy scatter nor
    ``np.repeat``: the rows are cut by ``pack_rows``."""
    eng = GpuEngineFilter(PATTERNS, chunk_bytes=CHUNK, device="cpu")
    lines = CASES["random"]
    payload, offsets, _, _, _ = framed(lines)
    exp = [oracle(PATTERNS, ln) for ln in lines]

    def refuse(*a, **k):
        raise AssertionError("host scatter on the dispatch path")

    calls = []
    plain = pack.pack_rows_plain
    monkeypatch.setattr(base, "pack_framed_rows", refuse)
    monkeypatch.setattr(np, "repeat", refuse)
    monkeypatch.setattr(pack, "pack_rows_plain",
                        lambda *a, **k: calls.append(a[3]) or plain(*a, **k))
    got = eng.fetch_framed(eng.dispatch_framed(payload, offsets))
    assert got.tolist() == exp
    assert {128, 256, 512, CHUNK} <= set(calls) and len(calls) > 6


# ---- the engine on the new path ------------------------------------------


def oracle(patterns, line: bytes) -> bool:
    body = line.rstrip(b"\n")
    return any(re.search(p.encode(), body) for p in patterns)


# The engine tests' chunk: short rows fall in the 128, 256, 512 and
# 1024 buckets. Their long rows are kept to one batch bucket of 8: the
# plain chunk step's [B, S] float product goes multi-threaded in MKL
# from 16 rows on, and two test processes doing that at once slow each
# other to a near standstill.
ENGINE_CHUNK = 1024


def engine_lines() -> list[bytes]:
    """Short rows of several width buckets, long rows (one a whole number
    of chunks), one row over SEQ_SCAN_BYTES, trailing newline runs, a
    final line without a newline."""
    rng = np.random.default_rng(11)
    needles = [b"panic:", b"retry 4/9", b"code=503", b"FATAL at code=7",
               b"start", b"end"]
    lines = [b"", b"\n\n", b"start here\n", b"the end\n\n\n", b"code=504\n",
             b"x" * 200 + b"end\n\n", b"CRIT " + b"y" * 240 + b"code=1\n"]
    for i, n in enumerate(rng.integers(0, ENGINE_CHUNK, size=36)):
        body = bytearray(rng.integers(32, 127, size=int(n)).astype(np.uint8))
        if i % 3 == 0 and n > 20:
            nd = needles[i % len(needles)]
            p = int(rng.integers(0, n - len(nd)))
            body[p:p + len(nd)] = nd
        lines.append(bytes(body) + b"\n" * (i % 4))
    C = ENGINE_CHUNK
    lines += [b"a" * (C - 3) + b"end\n", b"b" * (2 * C - 6) + b"panic:",
              b"c" * 2000 + b"retry 1/2\n\n", b"d" * C + b"\n",
              b"e" * (3 * C - 3) + b"end\n\n",
              b"y" * (GpuEngineFilter.SEQ_SCAN_BYTES + 300) + b"code=503\n",
              b"tail without newline end"]
    return lines


@pytest.mark.parametrize("env", [{}, {"KLOGS_TPU_SWEEP": "1"},
                                 {"KLOGS_TPU_PREFILTER": "1"},
                                 {"KLOGS_TPU_FUSED_GROUPS": "1"}],
                         ids=["k1", "sweep", "prefilter", "fused"])
def test_engine_dispatch_framed_equals_jax_and_oracle(env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = GpuEngineFilter(PATTERNS, chunk_bytes=ENGINE_CHUNK, device="cpu")
    ref = NFAEngineFilter(PATTERNS, chunk_bytes=ENGINE_CHUNK,
                          kernel="interpret")
    assert (port._sweep_tables is not None) == ("KLOGS_TPU_SWEEP" in env)
    assert (port._pf_tables is not None) == ("KLOGS_TPU_PREFILTER" in env)
    assert port._fused == ("KLOGS_TPU_FUSED_GROUPS" in env)
    lines = engine_lines()
    payload, offsets, _ = base.frame_lines(lines, strip_nl=False)
    nfa_kernels.reset_launches()
    layout, _ = port._layout(payload, offsets)
    assert [w for _, w, _, _ in layout] == [128, 256, 512, 1024, None]
    assert layout[-1][2] == 8
    got = port.fetch_framed(port.dispatch_framed(payload, offsets)).tolist()
    exp = [oracle(PATTERNS, ln) for ln in lines]
    assert got == exp and 8 <= sum(exp) < len(exp)
    assert ref.fetch_framed(ref.dispatch_framed(payload, offsets)).tolist() \
        == exp
    assert nfa_kernels.LAUNCHES[nfa_kernels.PACK] == 0  # plain versions
