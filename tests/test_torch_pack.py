"""The ragged pack (``ops/pack.py``) and the engine's framing on the
device, on the CPU: ``pack_rows_plain`` against the JAX package's numpy
scatter (``pack_framed_rows``), against the C packer the JAX engine
feeds its kernels (``hostops.pack_classify_framed``, compared after
``classify_chunk``) and against the JAX long-line path's chunk cuts;
``pack_classify_rows_plain`` (strip, pack and classify in one) against
that C packer on raw offsets and against the JAX long path's chunk
classes; then ``GpuEngineFilter.dispatch_framed`` against the JAX
engine (Pallas in interpret mode) and a ``re`` oracle on every path of
the short rows, with no host strip on the cls path and the sub-batch
stats and spans equal to JAX's. Inputs are made from seeds with numpy;
torch runs on one thread (several test workers each threading the
plain chunk step slow each other down)."""

import re

import numpy as np
import pytest
import torch

from klogs_tpu.filters import base as jbase
from klogs_tpu.filters.base import FilterStats as JaxFilterStats
from klogs_tpu.filters.tpu import NFAEngineFilter, classify_chunk_host
from klogs_tpu.native import hostops
from klogs_tpu.obs import trace as jtrace
from klogs_tpu_torch.filters import base, gpu
from klogs_tpu_torch.filters.base import FilterStats
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.filters.gpu import (GpuEngineFilter, _bucket_batch,
                                         strip_newlines)
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.ops import nfa, nfa_kernels, pack

PATTERNS = ["panic:", r"retry \d+/\d+", "code=50[34]", "^start", "end$",
            r"(?:FATAL|CRIT).*code=\d+"]
CHUNK = 4096


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # Raw lengths past a bucket or the chunk, stripped ones not; lines
    # of only newlines.
    "raw_crosses": [b"q" * 128 + b"\n", b"r" * 255 + b"\n\n\n",
                    b"s" * CHUNK + b"\n", b"t" * 4000 + b"\n" * 200,
                    b"\n" * 300, b"u" * 127 + b"\n", b"end\n\n\n"],
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
    payload, offsets, _, stripped_starts, stripped = framed(CASES["random"])
    # The cls path lays out raw lengths (the card strips), the bytes
    # path stripped ones (the host strips), as JAX's two paths do.
    for path, starts, lens in (("cls", offsets[:-1], np.diff(offsets)),
                               ("bytes", stripped_starts, stripped)):
        layout, meta = eng._layout(payload, offsets, path)
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


def grouped_cpu():
    prog, _, _ = nfa.compile_grouped(PATTERNS, device="cpu")
    assert prog.n_classes <= 127  # the C packer's int8 class ids
    return prog


@pytest.mark.parametrize("width", [128, 256, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_classify_rows_plain_equals_c_packer(case, width):
    """The fused plain version on raw starts and lengths equals the C
    framed packer (the JAX engine's cls path: raw offsets, strip inside)
    bucket-style, every line whose raw length fits ``width``, in order
    and a reversed subset, at the bucket's rows and at 37 more: class
    ids (int8 there, int16 here), stripped lengths, and the byte rows
    equal to the JAX scatter of the stripped lines."""
    prog = grouped_cpu()
    tab = prog.byte_class.numpy().astype(np.int8).tobytes()
    payload, offsets, pt, _, stripped = framed(CASES[case])
    raw = np.diff(offsets)
    fit = np.nonzero(raw <= width)[0].astype(np.int32)
    for sel in (fit, fit[::-2]):
        for rows in sorted({_bucket_batch(len(sel)), len(sel) + 37}):
            exp, exp_lens = hostops.pack_classify_framed(
                payload, offsets, len(offsets) - 1, sel.tobytes(), width,
                rows, tab, prog.begin_class, prog.end_class, prog.pad_class)
            cls, lens, batch = pack.pack_classify_rows(
                pt, t64(offsets[:-1][sel]), t64(raw[sel]), width, rows, prog,
                want_bytes=True)
            assert cls.dtype == torch.int16 and cls.shape == (rows, width + 3)
            assert torch.equal(cls, torch.from_numpy(np.frombuffer(
                exp, dtype=np.int8).reshape(rows, width + 3).astype(np.int16)))
            assert lens.tolist() == np.frombuffer(exp_lens,
                                                  dtype=np.int32).tolist()
            exp_b, _ = jbase.pack_framed_rows(payload, offsets, width,
                                              rows=rows, sel=sel,
                                              lens=stripped[sel])
            assert np.array_equal(batch.numpy(), exp_b)
            assert pack.pack_classify_rows(
                pt, t64(offsets[:-1][sel]), t64(raw[sel]), width, rows,
                prog)[2] is None


@pytest.mark.parametrize("case,L", [
    ("exact_chunks", 256), ("exact_chunks", CHUNK), ("trailing_runs", 256),
    ("raw_crosses", 256), ("raw_crosses", CHUNK), ("random", CHUNK)])
def test_chunk_classes_equal_jax_long_path(case, L):
    """Chunk k of the long lines (raw length past ``L``, as the JAX cls
    path splits them) classified at ``skip = k * L`` with ``first`` and
    ``final`` equals the JAX long path's ``classify_chunk_host`` of the
    stripped bodies' chunk k at ``rem = len - k * L``, for every k up to
    the chunk count of the raw lengths (which may pass the stripped
    one's by an all-PAD chunk), final or not."""
    aug = nfa.pack_program(nfa.augment(compile_patterns(PATTERNS)),
                           device="cpu")
    tab = aug.byte_class.numpy().astype(np.int8)
    payload, offsets, pt, starts, stripped = framed(CASES[case])
    raw = np.diff(offsets)
    rest = np.nonzero(raw > L)[0]
    assert len(rest)
    bodies = [payload[starts[i]:starts[i] + stripped[i]] for i in rest]
    B = _bucket_batch(len(rest))
    total = np.zeros(B, dtype=np.int64)
    total[:len(rest)] = stripped[rest]
    n_chunks = -(-int(raw[rest].max()) // L)
    assert n_chunks >= -(-int(total.max()) // L)
    for k in range(n_chunks):
        seg = [b[k * L:(k + 1) * L].ljust(L, b"\0") for b in bodies]
        chunk = np.frombuffer(b"".join(seg + [b"\0" * L] * (B - len(rest))),
                              dtype=np.uint8).reshape(B, L)
        for final in (False, True):
            cls, lens, _ = pack.pack_classify_rows(
                pt, t64(offsets[:-1][rest]), t64(raw[rest]), L, B, aug,
                skip=k * L, first=k == 0, final=final)
            exp = classify_chunk_host(chunk, total - k * L, tab,
                                      aug.begin_class, aug.end_class,
                                      aug.pad_class, first=k == 0,
                                      final=final)
            assert torch.equal(cls, torch.from_numpy(exp.astype(np.int16)))
            assert lens.tolist() == total.tolist()


def test_pack_classify_rows_edges():
    """No lines: BEGIN, END, PAD rows; ``skip`` past every line: PAD;
    a line of only newlines strips to 0; a payload tensor not on the
    CPU or a card raises, as do short ``rows``."""
    prog = grouped_cpu()
    b, e, p = prog.begin_class, prog.end_class, prog.pad_class
    none = torch.zeros(0, dtype=torch.int64)
    pt = torch.tensor(list(b"ab\n\n\n\n"), dtype=torch.uint8)
    cls, lens, _ = pack.pack_classify_rows(pt, none, none, 4, 8, prog)
    assert cls.tolist() == [[b, e, p, p, p, p, p]] * 8 and not lens.any()
    cls, lens, batch = pack.pack_classify_rows(
        pt, t64([0, 2]), t64([6, 4]), 4, 2, prog, skip=4, first=False,
        final=False, want_bytes=True)
    assert cls.tolist() == [[p] * 4] * 2 and lens.tolist() == [2, 0]
    assert not batch.any()
    with pytest.raises(ValueError):
        pack.pack_classify_rows(pt, t64([0, 1]), t64([1, 1]), 8, 1, prog)
    with pytest.raises(ValueError, match="device"):
        meta = torch.zeros(1, dtype=torch.int64, device="meta")
        pack.pack_classify_rows(torch.zeros(4, dtype=torch.uint8,
                                            device="meta"), meta, meta, 8, 1,
                                prog)


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


def test_cls_dispatch_strips_no_newlines_on_host(monkeypatch):
    """On the cls path the host calls no ``strip_newlines`` (the card's
    packer strips), and the verdicts still equal ``re``'s on lines with
    trailing newline runs; the bytes path (the sweep) strips on the host,
    as JAX's bytes path does."""
    lines = CASES["random"] + CASES["raw_crosses"]
    payload, offsets, _, _, _ = framed(lines)
    exp = [oracle(PATTERNS, ln) for ln in lines]
    calls = []
    monkeypatch.setattr(gpu, "strip_newlines",
                        lambda *a: calls.append(1) or strip_newlines(*a))
    eng = GpuEngineFilter(PATTERNS, chunk_bytes=CHUNK, device="cpu")
    assert eng._path() == "cls"
    assert eng.fetch_framed(eng.dispatch_framed(payload, offsets)).tolist() \
        == exp
    assert calls == []
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "1")
    swept = GpuEngineFilter(PATTERNS, chunk_bytes=CHUNK, device="cpu")
    assert swept._path() == "bytes"
    assert swept.fetch_framed(swept.dispatch_framed(payload,
                                                    offsets)).tolist() == exp
    assert calls == [1]


def stats_lines() -> list[bytes]:
    """Short lines whose raw lengths cross buckets their stripped
    lengths do not, newline-only lines, and one line whose raw length
    passes the chunk while its stripped length does not."""
    C = ENGINE_CHUNK
    return [b"a" * 128 + b"\n", b"end" * 40 + b"\n\n\n", b"\n" * 9,
            b"panic: x\n\n", b"b" * 255 + b"\n", b"c" * 511 + b"\n\n",
            b"code=503 " + b"d" * 600 + b"\n", b"", b"e" * (C - 1) + b"\n\n",
            b"f" * (C - 3) + b"end\n", b"tail"]


@pytest.mark.parametrize("env", [{}, {"KLOGS_TPU_SWEEP": "1"}],
                         ids=["cls", "bytes"])
def test_sub_batch_stats_and_spans_equal_jax(env, monkeypatch):
    """Each sub-batch's width, rows and payload bytes (``FilterStats``:
    the bucket-width histogram, payload and pad bytes) and each
    ``device.frame`` span's width, rows and path equal the JAX engine's
    on one frame, on the cls path (raw lengths) and the bytes path
    (stripped), and so do the verdicts."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    lines = stats_lines()
    payload, offsets, _ = base.frame_lines(lines, strip_nl=False)
    seen = {}
    for name, tracer, eng in (
            ("port", trace.TRACER, GpuEngineFilter(
                PATTERNS, chunk_bytes=ENGINE_CHUNK, device="cpu",
                stats=FilterStats())),
            ("jax", jtrace.TRACER, NFAEngineFilter(
                PATTERNS, chunk_bytes=ENGINE_CHUNK, kernel="interpret",
                stats=JaxFilterStats()))):
        spans, subs = [], []
        real_span, real_sub = tracer.span, eng._record_sub_batch

        def span(name_, _real=real_span, _spans=spans, **kw):
            if name_ == "device.frame" and "width" in kw:
                _spans.append((kw["width"], kw["rows"], kw["path"]))
            return _real(name_, **kw)

        monkeypatch.setattr(tracer, "span", span)
        monkeypatch.setattr(eng, "_record_sub_batch",
                            lambda *a, _s=subs, _r=real_sub:
                            _s.append(a) or _r(*a))
        got = eng.fetch_framed(eng.dispatch_framed(payload, offsets))
        r = eng._stats.registry
        seen[name] = dict(
            verdicts=got.tolist(), spans=sorted(
                (w, rows, p) for w, rows, p in spans if w is not None),
            subs=sorted(subs),
            widths=r.family("klogs_engine_bucket_width_bytes").labels()
            .snapshot(),
            payload=r.family("klogs_engine_payload_bytes_total").value,
            pad=r.family("klogs_engine_pad_bytes_total").value)
    assert seen["port"] == seen["jax"]
    assert seen["port"]["verdicts"] == [oracle(PATTERNS, ln) for ln in lines]
    path = "bytes" if env else "cls"
    assert {p for _, _, p in seen["port"]["spans"]} == {path}
    # Raw lengths: 513 bytes go to 1024 on the cls path, stripped 511 to
    # 512 on the bytes path.
    assert {w for w, _, _ in seen["port"]["spans"]} == (
        {128, 256, 1024} if path == "cls" else {128, 256, 512, 1024})


@pytest.mark.parametrize("grouped", [False, True], ids=["k2", "k2g"])
def test_trailing_pad_chunk_keeps_verdicts(grouped, monkeypatch):
    """Long lines whose raw lengths need one chunk more than their
    stripped lengths: the port runs that all-PAD chunk (its chunk count
    comes from raw lengths), and every verdict, ``$`` at the line's end
    included, equals the JAX engine's and ``re``'s, on K2 and on K2g."""
    if grouped:
        monkeypatch.setattr(gpu, "GROUPED_LONG_STATES", 0)
    C = ENGINE_CHUNK
    lines = [b"a" * (C - 3) + b"end" + b"\n\n", b"b" * (C - 6) + b"panic:\n",
             b"c" * 900 + b"\n" * 300, b"d" * C + b"\n" * (C + 1),
             b"x" * 2000 + b"code=503\n"]
    payload, offsets, _ = base.frame_lines(lines, strip_nl=False)
    port = GpuEngineFilter(PATTERNS, chunk_bytes=C, device="cpu")
    assert (port._long is not None) == grouped
    skips = []
    real = pack.pack_classify_rows

    def spy(*a, **kw):
        skips.append(kw.get("skip", 0))
        return real(*a, **kw)

    monkeypatch.setattr(pack, "pack_classify_rows", spy)
    got = port.fetch_framed(port.dispatch_framed(payload, offsets)).tolist()
    exp = [oracle(PATTERNS, ln) for ln in lines]
    assert got == exp and any(exp) and not all(exp)
    # Raw, the longest line is 2C + 1 bytes (3 chunks); stripped, 2008
    # (2 chunks, JAX's count).
    assert sorted(skips) == [0, C, 2 * C]
    ref = NFAEngineFilter(PATTERNS, chunk_bytes=C, kernel="interpret")
    assert ref.fetch_framed(ref.dispatch_framed(payload, offsets)).tolist() \
        == exp
