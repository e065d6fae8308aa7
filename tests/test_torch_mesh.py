"""The port's mesh engine (``klogs_tpu_torch/parallel/mesh.py``) on the
CPU, over a list of CPU devices (the kernels' plain versions), against
the JAX ``MeshEngine`` on the 8 virtual CPU devices of
``tests/conftest.py`` (``gspmd`` and ``pallas_interpret``) and Python
``re``: the grid, the OR across pattern shards, padding, the gates and
knobs, the engine factory and the CLI through it."""

import asyncio
import random
import re

import numpy as np
import pytest
import torch

from klogs_tpu.filters.base import FilterStats as JaxFilterStats
from klogs_tpu.filters.cpu import RegexFilter
from klogs_tpu.filters.tpu import NFAEngineFilter
from klogs_tpu.parallel import mesh as jax_mesh
from klogs_tpu_torch import app, cli
from klogs_tpu_torch.cluster.fake import FakeCluster
from klogs_tpu_torch.filters import base as port_base
from klogs_tpu_torch.filters import sink
from klogs_tpu_torch.filters.base import FilterStats
from klogs_tpu_torch.filters.gpu import GpuEngineFilter, ShortLines
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.ops import pack
from klogs_tpu_torch.parallel import mesh
from klogs_tpu_torch.parallel.mesh import MeshEngine
from klogs_tpu_torch.service.server import _uses_device_sweep
from tests.test_compiler import _rand_line, _rand_pattern, oracle


@pytest.fixture(autouse=True)
def one_thread():
    """The plain kernels' products on one thread: several test processes
    each spreading them over every core slow each other to a crawl."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device("cpu")
CLOCK = 1_753_800_000.0
GRIDS = [(8, 1), (4, 2), (2, 4), (1, 8)]
# tests/test_mesh.py's patterns and lines.
PATS = ["ERROR", r"WARN.*\d", "^2026", "timeout$", "a+b", "x{3}"]
LINES = [b"2026 ERROR x", b"all good", b"WARN 42", b"request timeout",
         b"aab", b"ab" * 40, b"", b"xxx", b"xx", b"2026-07-29 WARN latency=9"]
PF_PATS = ["panic:", "code=50[34]", "FATAL|CRIT", r"retry \d+/\d+",
           "broken pipe", "oom-killer"]
PF_LINES = [b"panic: x", b"fine here", b"code=504 y", b"CRIT", b"retry 9/9",
            b"a broken pipe", b"oom-killer hit", b""] * 5


def port_mesh(patterns, grid, n=None, **kw):
    n = grid[0] * grid[1] if n is None else n
    eng = MeshEngine(patterns, devices=[CPU] * n, grid=grid, **kw)
    return GpuEngineFilter(patterns, device="cpu", engine=eng)


def jax_filter(patterns, grid, impl, n=None, **kw):
    import jax

    n = grid[0] * grid[1] if n is None else n
    eng = jax_mesh.MeshEngine(patterns, devices=jax.devices()[:n], grid=grid,
                              impl=impl)
    return NFAEngineFilter(patterns, engine=eng, **kw)


def literal_set(k: int) -> list[str]:
    """K literal-led patterns: every one has mandatory factors (the
    sweep) and byte pairs (the pair-CNF)."""
    return [f"svc-{i:03d} (down|fail)" for i in range(k)]


def literal_lines(k: int, n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        j = int(rng.integers(0, k + 20))
        verb = (b"down", b"fail", b"up")[i % 3]
        out.append(b"t=%d svc-%03d %s code=%d" % (i, j, verb, i % 7))
    return out


def test_choose_grid_and_split_patterns_equal_jax():
    for n_dev in range(1, 17):
        for n_pat in range(1, 41):
            assert mesh.choose_grid(n_dev, n_pat) == \
                jax_mesh.choose_grid(n_dev, n_pat), (n_dev, n_pat)
            pats = [f"p{i}" for i in range(n_pat)]
            assert mesh.split_patterns(pats, n_dev) == \
                jax_mesh.split_patterns(pats, n_dev)


@pytest.mark.parametrize("impl", ["gspmd", "pallas_interpret"])
@pytest.mark.parametrize("grid", GRIDS)
def test_mesh_grids_equal_jax(grid, impl):
    got = port_mesh(PATS, grid).match_lines(LINES)
    assert got == jax_filter(PATS, grid, impl).match_lines(LINES)
    assert got == RegexFilter(PATS).match_lines(LINES)


def test_grid_layout_and_errors():
    eng = MeshEngine(PATS, devices=[CPU] * 8)
    assert eng.grid == jax_mesh.choose_grid(8, len(PATS)) == (4, 2)
    assert eng.data_parallelism == 4
    assert not eng.gated and not eng.swept
    # Data-major: device i is shard divmod(i, g); one compiled program a
    # pattern shard on a repeated device.
    assert [(di, gi) for di, gi, _ in eng._local] == \
        [divmod(i, 2) for i in range(8)]
    assert len({id(sh) for sh in eng._shards.values()}) == 2
    with pytest.raises(ValueError, match="grid"):
        MeshEngine(PATS, devices=[CPU] * 8, grid=(3, 2))
    with pytest.raises(ValueError, match="device"):
        GpuEngineFilter(PATS, device="meta", engine=eng)


def test_uneven_batch_padding_launches_only_real_rows(monkeypatch):
    """3 lines over 8 data shards: the bucket's 8 rows give one row a
    shard, the 5 shards of padding launch nothing and their verdicts
    are dropped."""
    calls = []
    real = pack.pack_classify_rows

    def counting(*a, **kw):
        calls.append(a[4])
        return real(*a, **kw)

    monkeypatch.setattr(pack, "pack_classify_rows", counting)
    f = port_mesh(["foo"], (8, 1))
    assert f.match_lines([b"foo", b"bar", b"xfoo"]) == [True, False, True]
    assert calls == [1, 1, 1]
    assert jax_filter(["foo"], (8, 1), "gspmd").match_lines(
        [b"foo", b"bar", b"xfoo"]) == [True, False, True]


def test_rows_pad_to_a_multiple_of_the_data_shards():
    """3 data shards over the 10 lines' bucket of 16 rows: 18 rows, 6 a
    shard, the last shard's 2 rows of padding only."""
    f = port_mesh(PATS, (3, 1))
    layout, meta = f._layout(*port_base.frame_lines(LINES, strip_nl=False)[:2])
    assert [rows for _, _, rows, _ in layout] == [18]
    assert meta[18 + 10:].tolist() == [0] * 8
    assert f.match_lines(LINES) == RegexFilter(PATS).match_lines(LINES)


def test_more_shards_than_patterns_replicates():
    f = port_mesh(["only"], (2, 4))
    assert f._engine.grid == (2, 4)
    assert f.match_lines([b"the only one", b"nope"]) == [True, False]
    assert jax_filter(["only"], (2, 4), "gspmd").match_lines(
        [b"the only one", b"nope"]) == [True, False]


@pytest.mark.parametrize("impl", ["gspmd", "pallas_interpret"])
def test_mixed_match_all_across_pattern_shards(impl):
    """'a*' matches every line; alone on its pattern shard it still
    compiles, and the OR gives every line."""
    for lines in ([b"ERROR x", b"clean"], [b"zzz"]):
        got = port_mesh(["a*", "ERROR"], (4, 2)).match_lines(lines)
        assert got == [True] * len(lines)
        assert got == jax_filter(["a*", "ERROR"], (4, 2),
                                 impl).match_lines(lines)
    # A shard holding only the match-all pattern, the filter's shortcut
    # off: its rows are all true.
    f = port_mesh(["a*", "ERROR"], (4, 2))
    f._match_all = False
    assert f.match_lines([b"zzz", b"ERROR"]) == [True, True]


@pytest.mark.parametrize("impl", ["gspmd", "pallas_interpret"])
def test_boundary_and_anchored_patterns_across_pattern_shards(impl):
    pats = [r"\berror\b", r"code=50[34]", r"warn\B", r"\bFATAL", r"x\d+\b",
            "^start", "end$"]
    lines = [b"error", b"errors", b"an error.", b"code=503", b"warned",
             b"warn", b"FATAL x", b"xFATAL", b"x42", b"x42y", b"", b"-",
             b"start x", b"x start", b"the end", b"end x"] * 2
    got = port_mesh(pats, (4, 2)).match_lines(lines)
    assert got == [oracle(pats, ln) for ln in lines]
    assert got == jax_filter(pats, (4, 2), impl).match_lines(lines)


def test_long_lines_stay_on_the_first_device(monkeypatch):
    """Lines past chunk_bytes run K2 on the filter's device (the mesh's
    first), unsharded; short lines on the mesh."""
    seen = []
    real = mesh.MeshEngine.dispatch_rows

    def spy(self, staged, at, rows, n_lines, width):
        seen.append((rows, n_lines, width))
        return real(self, staged, at, rows, n_lines, width)

    monkeypatch.setattr(mesh.MeshEngine, "dispatch_rows", spy)
    lines = [b"x" * 300 + b"ERROR", b"y" * 700, b"ERROR", b"ok"]
    eng = MeshEngine(PATS, devices=[CPU] * 4, grid=(2, 2))
    f = GpuEngineFilter(PATS, device="cpu", chunk_bytes=256, engine=eng)
    assert f.match_lines(lines) == [True, False, True, False]
    assert seen == [(8, 2, 128)]
    assert f.device == CPU and f._grouped is None


def test_include_exclude_through_the_engine_factory(monkeypatch):
    """make_pipeline with the device list at four entries builds both
    sides on MeshEngines; their verdicts equal JAX's pipeline (a mesh
    over its 8 virtual devices) and re."""
    from klogs_tpu.filters.sink import make_pipeline as jax_make_pipeline

    monkeypatch.setattr(mesh, "engine_devices", lambda device=None: [CPU] * 4)
    p = sink.make_pipeline(["ERROR", r"\bpanic\b"], "cuda",
                           exclude=["healthz"], device="cpu")
    inc, exc = p.log_filter.include, p.log_filter.exclude
    assert isinstance(inc._engine, MeshEngine)
    assert isinstance(exc._engine, MeshEngine)
    lines = [b"ERROR up", b"ERROR healthz", b"panic: x", b"panics",
             b"healthz ok", b"fine"] * 4
    want = [(bool(re.search(rb"ERROR", ln) or re.search(rb"\bpanic\b", ln))
             and not re.search(rb"healthz", ln)) for ln in lines]
    got = p.log_filter.match_lines(lines)
    assert got == want
    jp = jax_make_pipeline(["ERROR", r"\bpanic\b"], "tpu", exclude=["healthz"])
    assert jp.log_filter.match_lines(lines) == got
    jp.close()
    asyncio.run(p.aclose())
    assert inc._engine._shards == {} and inc._aug is None


def test_one_device_builds_no_mesh(monkeypatch):
    p = sink.make_pipeline(["ERROR"], "cuda", device="cpu")
    assert p.log_filter._engine is None
    asyncio.run(p.aclose())
    assert mesh.engine_devices("cpu") == [CPU]


def test_app_run_through_the_mesh_equals_oracle_and_jax(tmp_path,
                                                        monkeypatch):
    """The CLI's main path with the device list patched to four CPU
    devices: the engine is a MeshEngine, every file is the oracle's
    selection and JAX's (whose CLI builds a mesh on its 8 devices)."""
    from klogs_tpu import app as jax_app
    from klogs_tpu.cli import parse_args as jax_parse_args
    from klogs_tpu.cluster.fake import FakeCluster as JaxFakeCluster

    monkeypatch.setattr(mesh, "engine_devices", lambda device=None: [CPU] * 4)
    built = []
    real = sink.make_pipeline

    def capture(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(sink, "make_pipeline", capture)
    args = ["-n", "default", "-a", "--match", r"(?:ERROR|WARN).*\d",
            "--match", "latency=4[0-9]ms", "--stats"]
    outs = {}
    for side in ("torch", "jax"):
        out = tmp_path / side
        if side == "torch":
            fc = FakeCluster.synthetic(n_pods=3, lines_per_container=120,
                                       clock=lambda: CLOCK)
            run = app.run_async(cli.parse_args(args + ["-p", str(out)]),
                                backend=fc, device="cpu")
        else:
            fc = JaxFakeCluster.synthetic(n_pods=3, lines_per_container=120,
                                          clock=lambda: CLOCK)
            run = jax_app.run_async(
                jax_parse_args(args + ["-p", str(out), "--backend", "tpu"]),
                backend=fc)
        assert asyncio.run(run) == 0
        outs[side] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
        if side == "torch":
            pods = fc.namespaces["default"]
            want = {f"{n}__c0.log": b"".join(
                ln for _, ln in pods[n].containers["c0"].lines
                if re.search(rb"(?:ERROR|WARN).*\d|latency=4[0-9]ms",
                             ln.rstrip(b"\n")))
                for n in sorted(pods)}
    assert isinstance(built[0].log_filter._engine, MeshEngine)
    assert outs["torch"] == want
    assert outs["torch"] == outs["jax"]


def test_prefilter_on_every_shard_equals_jax(monkeypatch):
    monkeypatch.setenv("KLOGS_TPU_PREFILTER", "1")
    f = port_mesh(PF_PATS, (2, 2))
    assert f._engine.gated and not f._engine.swept
    assert all(sh._pf_tables is not None
               for sh in f._engine._shards.values())
    got = f.match_lines(PF_LINES)
    assert got == RegexFilter(PF_PATS).match_lines(PF_LINES)
    j = jax_filter(PF_PATS, (2, 2), "pallas_interpret", kernel="interpret")
    assert j._engine.gated
    assert got == j.match_lines(PF_LINES)


def test_prefilter_all_or_none_and_its_notice_equal_jax(monkeypatch, capsys):
    """One shard without mandatory byte pairs turns the gate off on every
    shard; the filter says so for the whole set, in JAX's words, and
    keeps the reason in its stats."""
    monkeypatch.setenv("KLOGS_TPU_PREFILTER", "1")
    pats = PF_PATS + ["a"]
    stats = FilterStats()
    eng = MeshEngine(pats, devices=[CPU] * 4, grid=(2, 2))
    f = GpuEngineFilter(pats, device="cpu", engine=eng, stats=stats)
    port_out = capsys.readouterr().out
    assert not eng.gated
    jstats = JaxFilterStats()
    j = jax_filter(pats, (2, 2), "pallas_interpret", kernel="interpret",
                   stats=jstats)
    jax_out = capsys.readouterr().out
    assert not j._engine.gated
    assert stats.pf_disabled_reason == jstats.pf_disabled_reason
    assert "no mandatory byte pairs for pattern(s) 'a'" in port_out
    assert port_out == jax_out
    lines = PF_LINES + [b"a"]
    assert f.match_lines(lines) == j.match_lines(lines) == \
        RegexFilter(pats).match_lines(lines)
    assert stats.pf_lines == 0


def test_forced_sweep_on_every_shard_equals_jax(monkeypatch, capsys):
    """KLOGS_TPU_SWEEP=1 at K = 64: each shard sweeps its own patterns
    (its own pattern -> group map); with the prefilter asked for too,
    the sweep supersedes it on the mesh, in JAX's words."""
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "1")
    monkeypatch.setenv("KLOGS_TPU_PREFILTER", "1")
    pats = literal_set(64)
    lines = literal_lines(64, 96, seed=3)
    f = port_mesh(pats, (2, 2))
    port_out = capsys.readouterr().out
    eng = f._engine
    assert eng.swept and not eng.gated and f._path() == "bytes"
    for (gi, _), sh in eng._shards.items():
        assert sh._sweep_tables is not None and sh._pf_tables is None
        assert sh._sweep_tables.n_groups == sh._grouped.follow.shape[0]
        assert sh._n_patterns == len(mesh.split_patterns(pats, 2)[gi])
    assert _uses_device_sweep(f)
    j = jax_filter(pats, (2, 2), "pallas_interpret", kernel="interpret")
    jax_out = capsys.readouterr().out
    assert j._engine.swept
    assert "supersedes KLOGS_TPU_PREFILTER on the mesh" in port_out
    assert port_out == jax_out
    got = f.match_lines(lines)
    assert got == j.match_lines(lines) == RegexFilter(pats).match_lines(lines)
    assert sum(got) > 0


def test_sweep_off_on_the_cpu_in_auto_mode():
    eng = MeshEngine(literal_set(64), devices=[CPU] * 2, grid=(1, 2))
    assert not eng.swept and not eng.gated
    assert not _uses_device_sweep(GpuEngineFilter(
        literal_set(64), device="cpu", engine=eng))


def test_fused_knob_warns_and_runs_the_default_kernel(monkeypatch, capsys):
    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "1")
    f = port_mesh(PATS, (4, 2))
    port_out = capsys.readouterr().out
    assert "no mesh per-shard variant" in port_out
    assert not f._fused
    assert not any(sh._fused for sh in f._engine._shards.values())
    jax_filter(PATS, (4, 2), "pallas_interpret")
    assert port_out == capsys.readouterr().out
    assert f.match_lines(LINES) == RegexFilter(PATS).match_lines(LINES)


def test_stats_count_each_sub_batch_once(monkeypatch):
    seen = {"single": [], "mesh": []}
    lines = LINES + [b"y" * 200 + b"ERROR", b"z" * 600] * 3
    for side in seen:
        stats = FilterStats()
        monkeypatch.setattr(stats, "record_engine_batch",
                            lambda *a, _s=side: seen[_s].append(a))
        if side == "single":
            f = GpuEngineFilter(PATS, device="cpu", stats=stats)
        else:
            f = GpuEngineFilter(PATS, device="cpu", stats=stats,
                                engine=MeshEngine(PATS, devices=[CPU] * 4,
                                                  grid=(2, 2)))
        f.match_lines(lines)
    assert seen["mesh"] == seen["single"] and len(seen["single"]) == 3


def test_mesh_dispatch_span(monkeypatch):
    trace.reset(1.0)
    spans = []
    monkeypatch.setattr(trace.TRACER, "span",
                        lambda name, **kw: spans.append((name, kw))
                        or trace.NOOP_SPAN)
    try:
        port_mesh(PATS, (2, 2)).match_lines(LINES)
    finally:
        trace.reset(None)
    assert ("mesh.dispatch", {"rows": 16, "grid": "2x2", "gated": False}) \
        in spans


def test_shard_program_copies_to_a_device_with_a_fresh_cache():
    sh = ShortLines(PATS, device="cpu")
    zeros = torch.zeros(16, dtype=torch.uint8)
    sh._match_short(zeros, torch.zeros(4, dtype=torch.int64),
                    torch.tensor([0, 3, 5, 16]), 16, 4)
    moved = sh.to(CPU)
    assert moved._grouped is not sh._grouped
    assert moved._grouped.cache == {} and moved._grouped.cache is not \
        sh._grouped.cache
    assert torch.equal(moved._grouped.follow, sh._grouped.follow)
    line = torch.frombuffer(bytearray(b"WARN 7\n"), dtype=torch.uint8)
    assert moved._match_short(line, torch.tensor([0]), torch.tensor([7]),
                              16, 1)[0].tolist() == [True]


def test_property_mesh_vs_jax_and_re():
    """Seeded random pattern sets on each grid in turn: the port's mesh
    equals Python re on every set, and the JAX gspmd mesh on every
    other one."""
    rng = random.Random(15)
    tested = against_jax = 0
    while tested < 240:
        k = rng.randrange(1, 7)
        pats = [_rand_pattern(rng) for _ in range(k)]
        try:
            for p in pats:
                re.compile(p.encode())
            grid = GRIDS[tested % 4]
            f = port_mesh(pats, grid)
        except (ValueError, re.error):
            continue
        lines = [_rand_line(rng) for _ in range(21)]  # uneven on purpose
        got = f.match_lines(lines)
        assert got == [oracle(pats, ln) for ln in lines], pats
        if tested % 2 == 0:
            assert got == jax_filter(pats, (4, 2), "gspmd").match_lines(
                lines), pats
            against_jax += 1
        tested += 1
    assert against_jax == 120


def test_mesh_raises_where_a_shard_cannot_build(monkeypatch):
    """No degrade: a shard's failed table build raises out of the
    engine's construction."""
    monkeypatch.setenv("KLOGS_TPU_SWEEP", "1")

    def broken(self, patterns, ignore_case):
        raise RuntimeError("sweep tables failed")

    monkeypatch.setattr(ShortLines, "_build_sweep", broken)
    with pytest.raises(RuntimeError, match="sweep tables failed"):
        MeshEngine(literal_set(8), devices=[CPU] * 2, grid=(1, 2))
