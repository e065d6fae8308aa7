"""The fused-groups path (``KLOGS_TPU_FUSED_GROUPS=1``) on the CPU: K4's
plain version against the JAX fused Pallas kernel in interpret mode and
a ``re`` oracle; the fused engine against the JAX engine under the same
variable; and the rule that the fused kernel takes no gate. Exact
equality: verdicts are booleans."""

import io
import re

import numpy as np
import pytest
import torch

import bench
from klogs_tpu.filters.base import IncludeExcludeFilter as JaxIncludeExclude
from klogs_tpu.filters.tpu import NFAEngineFilter
from klogs_tpu.ops import nfa as jnfa
from klogs_tpu.ops import pallas_nfa
from klogs_tpu_torch.cluster.fake import synthetic_line
from klogs_tpu_torch.filters import cpu
from klogs_tpu_torch.filters.base import build_include_exclude, frame_lines
from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
from klogs_tpu_torch.filters.gpu import GpuEngineFilter
from klogs_tpu_torch.ops import nfa, nfa_kernels
from klogs_tpu_torch.ui import term

# tests/test_grouped.py's fused parity case: several groups of at most
# 24 positions, anchors, 77 rows (not a tile multiple).
GROUPED_PATS = ["panic:", "code=50[34]", "^FATAL", r"x[0-9]{2,}y", "a.*b.*c",
                r"(?:err|warn)\d+", "end$"] * 3
GROUPED_LINES = [b"panic: now", b"code=504", b"FATAL x", b"zFATAL x",
                 b"x123y!", b"abc", b"a-b-c", b"warn77", b"the end",
                 b"end it", b""] * 7


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions' batched products on one thread: several test
    processes each spreading them over every core slow each other to a
    crawl (the wide cases step 1152-state groups)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def oracle(patterns, line: bytes) -> bool:
    body = line.rstrip(b"\n")
    return any(re.search(p.encode(), body) for p in patterns)


def rows_of(lines: list[bytes], width: int):
    rows = np.zeros((len(lines), width), dtype=np.uint8)
    lens = np.zeros(len(lines), dtype=np.int32)
    for i, ln in enumerate(lines):
        rows[i, :len(ln)] = np.frombuffer(ln, dtype=np.uint8)
        lens[i] = len(ln)
    return rows, lens


def fused_vs_pallas(patterns, lines, width: int, max_positions: int = 126):
    """(port K4 plain verdicts, JAX fused interpret verdicts, G) on the
    same class ids."""
    tp, live, acc = nfa.compile_grouped(patterns, max_positions=max_positions,
                                        device="cpu")
    jdp, _, _ = jnfa.compile_grouped(patterns, max_positions=max_positions)
    rows, lens = rows_of(lines, width)
    cls = nfa.classify_chunk(tp, torch.from_numpy(rows), torch.from_numpy(lens),
                             True, True)
    got = nfa_kernels.match_cls_grouped_fused(tp, live, acc, cls)
    exp = np.asarray(pallas_nfa.match_cls_grouped_pallas(
        jdp, live, acc, cls.numpy().astype(np.int32), tile_b=16,
        interpret=True, fused=True))
    return got.tolist(), exp.tolist(), int(tp.follow.shape[0])


def test_fused_plain_equals_pallas_fused_multi_group():
    got, exp, G = fused_vs_pallas(GROUPED_PATS, GROUPED_LINES, 32,
                                  max_positions=24)
    assert G >= 3 and len(got) == 77
    assert got == exp == [oracle(GROUPED_PATS, ln) for ln in GROUPED_LINES]
    assert any(got) and not all(got)


def fake_lines(n: int, seed: int) -> list[bytes]:
    """FakeCluster lines (trailing newline stripped, as the engine
    does), a needle of the 32-pattern set planted in every fifth."""
    rng = np.random.default_rng(seed)
    needles = [b"panic: x", b"code=503", b"retry 3/5", b"uid=1234567",
               b"EPIPE", b"disk is full"]
    out = []
    for i in range(n):
        ln = synthetic_line(f"pod-{i % 7:04d}", "c0", i, 1.7e9 + i).rstrip(b"\n")
        if i % 5 == 0:
            p = int(rng.integers(0, 40))
            ln = ln[:p] + needles[(i // 5) % len(needles)] + ln[p:]
        out.append(ln)
    return out


def test_fused_plain_equals_pallas_fused_bench_patterns():
    lines = fake_lines(40, 3)
    got, exp, G = fused_vs_pallas(bench.PATTERNS, lines, 160)
    assert G == 4
    assert got == exp == [oracle(bench.PATTERNS, ln) for ln in lines]
    assert sum(got) >= 8


def test_fused_plain_is_k1_plain():
    """K4 computes K1's function: the plain versions are one."""
    assert (nfa_kernels.match_cls_grouped_fused_plain
            is nfa_kernels.match_cls_grouped_plain)


def test_fused_wrapper_rejects_other_devices_and_programs():
    tp, live, acc = nfa.compile_grouped(["abc"], device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        nfa_kernels.match_cls_grouped_fused(
            tp, live, acc, torch.zeros((2, 4), dtype=torch.int16,
                                       device="meta"))
    single = nfa.pack_program(nfa.augment(compile_patterns(["abc"])),
                              device="cpu")
    with pytest.raises(ValueError, match="compile_grouped"):
        nfa_kernels.match_cls_grouped_fused(
            single, live, acc, torch.zeros((2, 4), dtype=torch.int16))


# ---- the fused engine -----------------------------------------------------

CHUNK = 256
ENGINE_PATS = ["panic:", r"retry \d+/\d+", "code=50[34]", "^start", "end$",
               r"(?:FATAL|CRIT).*code=\d+"]


def engine_lines() -> list[bytes]:
    rng = np.random.default_rng(11)
    lines = [b"", b"\n", b"start here\n", b"not at the end", b"the end\n\n",
             b"code=503", b"code=502"]
    for i in range(24):
        n = int(rng.integers(0, 3 * CHUNK))
        body = bytearray(rng.integers(32, 127, size=n).astype(np.uint8))
        if i % 3 == 0 and n > 20:
            nd = [b"panic:", b"retry 4/9", b"FATAL at code=7"][i // 3 % 3]
            p = int(rng.integers(0, n - len(nd)))
            body[p:p + len(nd)] = nd
        lines.append(bytes(body) + (b"\n" if i % 2 else b""))
    # Past 4 KiB, with a needle across the 256-byte chunk edges.
    lines.append(b"q" * 4500 + b"code=504")
    lines.append(b"w" * (2 * CHUNK - 3) + b"retry 1/2" + b"w" * 4200)
    return lines


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "1")
    monkeypatch.delenv("KLOGS_TPU_SWEEP", raising=False)
    monkeypatch.delenv("KLOGS_TPU_PREFILTER", raising=False)


def test_fused_engine_equals_jax_fused_and_oracle(fused_env, monkeypatch):
    """Short lines go through the fused wrapper (K1's is never called),
    long ones through the chunk path, and every verdict equals the JAX
    engine's under the same variable and the oracle."""
    calls = []
    fused = nfa_kernels.match_cls_grouped_fused

    def recording(prog, live, acc, cls):
        calls.append(tuple(cls.shape))
        return fused(prog, live, acc, cls)

    def k1(*a, **kw):
        raise AssertionError("K1 ran under KLOGS_TPU_FUSED_GROUPS=1")

    monkeypatch.setattr(nfa_kernels, "match_cls_grouped_fused", recording)
    monkeypatch.setattr(nfa_kernels, "match_cls_grouped", k1)
    port = GpuEngineFilter(ENGINE_PATS, chunk_bytes=CHUNK, device="cpu")
    ref = NFAEngineFilter(ENGINE_PATS, chunk_bytes=CHUNK, kernel="interpret")
    assert ref._chain_kwargs(True)[0] == {"fused": True}
    lines = engine_lines()
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    got = port.fetch_framed(port.dispatch_framed(payload, offsets)).tolist()
    assert got == ref.match_lines(lines)
    assert got == [oracle(ENGINE_PATS, ln) for ln in lines]
    assert got[-2] and got[-1] and any(got[:-2])
    assert calls and {w for _, w in calls} == {CHUNK + 3, 128 + 3}


def test_fused_engine_wide_set_equals_jax_fused_and_oracle(fused_env,
                                                         monkeypatch):
    """The 32 bench patterns and the watch list (``chip_smoke.WATCH``: 5
    groups of 1152 states, 36 words) under the variable: short lines go
    through the fused wrapper at that width (K4's card kernel there is
    ``grouped_fused_wide_kernel``), K1's is never called, the long lines
    take K2g over the grouped automata; every verdict equals the JAX
    engine's under the same variable (its fused Pallas kernel in
    interpret mode) and the oracle."""
    import chip_smoke

    pats = list(bench.PATTERNS) + [chip_smoke.WATCH]
    widths = []
    fused = nfa_kernels.match_cls_grouped_fused

    def recording(prog, live, acc, cls):
        widths.append(nfa_kernels.kernel_states(prog.n_states) // 32)
        return fused(prog, live, acc, cls)

    def k1(*a, **kw):
        raise AssertionError("K1 ran under KLOGS_TPU_FUSED_GROUPS=1")

    monkeypatch.setattr(nfa_kernels, "match_cls_grouped_fused", recording)
    monkeypatch.setattr(nfa_kernels, "match_cls_grouped", k1)
    port = GpuEngineFilter(pats, device="cpu")
    assert port._fused and port._aug is None
    assert port._grouped.follow.shape[0] == 5
    rng = np.random.default_rng(12)
    lines = [ln + b"\n" for ln in fake_lines(48, 12)]
    lines += [b"pod=pod-0255", b"x pod=pod-01", b"pod=pod-0256",
              b"pod=pod-0129 and panic: too", b""]
    for nd, at in ((b"pod=pod-0033", 4090), (b"pod=pod-0012", 5000)):
        size = int(rng.integers(4097, 6 * 1024))
        body = bytearray(rng.integers(32, 127, size=size, dtype=np.uint8))
        body[at - len(nd):at] = nd
        lines.append(bytes(body))
    payload, offsets, _ = frame_lines(lines, strip_nl=False)
    got = port.fetch_framed(port.dispatch_framed(payload, offsets)).tolist()
    ref = NFAEngineFilter(pats, kernel="interpret")
    assert ref._chain_kwargs(True)[0] == {"fused": True}
    exp = [oracle(pats, ln) for ln in lines]
    assert got == exp
    assert ref.match_lines(lines) == exp
    assert any(exp[:48]) and not all(exp[:48])
    assert exp[-7:] == [True, False, False, True, False, True, False]
    assert widths and set(widths) == {36}


def test_fused_include_exclude_equals_jax(fused_env):
    inc, exc = ["code=50[0-9]", "panic:"], [r"code=503", "quiet"]
    lines = [b"code=500", b"code=503", b"panic: quiet", b"panic: loud",
             b"nothing", b"code=504 " + b"z" * 600]
    port = build_include_exclude(
        lambda p: GpuEngineFilter(p, chunk_bytes=CHUNK, device="cpu"),
        inc, exc)
    ref = JaxIncludeExclude(
        NFAEngineFilter(inc, chunk_bytes=CHUNK, kernel="interpret"),
        NFAEngineFilter(exc, chunk_bytes=CHUNK, kernel="interpret"))
    exp = [oracle(inc, ln) and not oracle(exc, ln) for ln in lines]
    assert port.match_lines(lines) == ref.match_lines(lines) == exp


# ---- fused versus the gates -------------------------------------------------

K64 = bench.make_patterns(64)


@pytest.mark.parametrize("var", ["KLOGS_TPU_SWEEP", "KLOGS_TPU_PREFILTER"])
def test_fused_with_forced_gate_raises(fused_env, monkeypatch, var):
    monkeypatch.setenv(var, "1")
    with pytest.raises(ValueError, match=f"no gated variant.*{var}"):
        GpuEngineFilter(K64, device="cpu")
    with pytest.raises(ValueError, match=var):
        cpu.check_fused_gates(1024, torch.device("cuda"))


def test_fused_auto_sweep_stays_off_with_a_notice(fused_env):
    """Where auto mode would sweep (K >= 64 on cuda; no card needed to
    ask), the fused rule keeps the sweep off and says why; on the CPU,
    or with the sweep turned off, it says nothing."""
    ui = io.StringIO()
    term.set_ui_stream(ui)
    try:
        assert cpu.device_sweep_wanted(1024, torch.device("cuda"))
        cpu.check_fused_gates(1024, torch.device("cuda"))
        said = ui.getvalue()
        cpu.check_fused_gates(1024, torch.device("cpu"))
        cpu.check_fused_gates(10, torch.device("cuda"))
        eng = GpuEngineFilter(K64, device="cpu")
    finally:
        term.set_ui_stream(None)
    assert "KLOGS_TPU_FUSED_GROUPS=1 active; device sweep stays off" in said
    assert ui.getvalue() == said
    assert eng._fused and eng._sweep_tables is None and eng._pf_tables is None


def test_fused_with_sweep_off_is_quiet(fused_env, monkeypatch):
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "0")
    ui = io.StringIO()
    term.set_ui_stream(ui)
    try:
        cpu.check_fused_gates(1024, torch.device("cuda"))
    finally:
        term.set_ui_stream(None)
    assert ui.getvalue() == ""


def test_engine_without_the_variable_keeps_k1(monkeypatch):
    monkeypatch.delenv("KLOGS_TPU_FUSED_GROUPS", raising=False)
    assert not GpuEngineFilter(["x"], device="cpu")._fused
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "0")
    assert not GpuEngineFilter(["x"], device="cpu")._fused
