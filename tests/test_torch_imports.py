"""Guardrails of the port: it imports neither JAX nor the JAX package,
its CUDA entry points (the fused path's too) refuse to run without a
card (no silent CPU fallback), its kernel build refuses without nvcc, and chip_smoke.py
exits non-zero, printing no result, where there is no GPU or no
checkout beside it."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "klogs_tpu_torch")


def port_sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_modules(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.append(node.module)
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    files = port_sources()
    assert len(files) > 20
    for mod in ("ops/tune.py", "ops/nfa_kernels.py", "ops/pack.py",
                "filters/gpu.py", "filters/cpu.py", "filters/sink.py",
                "runtime/fanout.py", "runtime/stdout.py", "cluster/fake.py",
                "cluster/kube.py", "cluster/kubeconfig.py",
                "resilience/policy.py", "ui/interactive.py", "app.py",
                "cli.py", "version.py", "sources/__init__.py",
                "sources/base.py", "sources/cluster.py", "sources/replay.py",
                "sources/archive.py", "sources/socket.py", "utils/env.py",
                "obs/__init__.py", "obs/metrics.py", "obs/expo.py",
                "obs/inventory.py", "obs/trace.py", "obs/profiler.py",
                "obs/http.py", "resilience/__init__.py",
                "resilience/faults.py", "service/__init__.py",
                "service/__main__.py", "service/transport.py",
                "service/client.py", "service/server.py"):
        assert os.path.join(PORT, mod) in files
    bad = []
    for path in files:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "klogs_tpu"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_port_package_imports_without_jax():
    """Every port module imports in a fresh interpreter with jax and the
    JAX package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'klogs_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import klogs_tpu_torch\n"
        "for m in pkgutil.walk_packages(klogs_tpu_torch.__path__, "
        "'klogs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_sources_import_first_in_a_fresh_interpreter():
    """``klogs_tpu_torch.sources`` (and each source module) imports
    before anything else of the port, with no import cycle through
    ``cluster/``."""
    for mod in ("klogs_tpu_torch.sources", "klogs_tpu_torch.sources.base",
                "klogs_tpu_torch.sources.archive",
                "klogs_tpu_torch.sources.socket",
                "klogs_tpu_torch.sources.cluster"):
        code = (f"import {mod}, sys\n"
                "from klogs_tpu_torch.sources import make_source, SourceError\n"
                "from klogs_tpu_torch.cluster.backend import StreamError\n"
                "assert issubclass(StreamError, SourceError)\n"
                "print('ok')\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip() == "ok"


def test_cuda_entry_points_raise_without_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from klogs_tpu_torch.filters.compiler.glushkov import compile_patterns
    from klogs_tpu_torch.filters.compiler.prefilter import compile_prefilter
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.filters.sink import make_pipeline
    from klogs_tpu_torch.ops import nfa, prefilter, sweep
    from klogs_tpu_torch.ops.nfa import augment, pack_program
    from klogs_tpu_torch.filters.compiler.groups import analyze, plan_groups
    from klogs_tpu_torch.filters.compiler.index import FactorIndex

    union = compile_patterns(["x"])
    infos = analyze(["xyz1"])
    prog = FactorIndex(infos, plan_groups(infos)).sweep_program()
    pf = compile_prefilter(["xyz1"])
    for entry in (lambda: pack_program(augment(union)),
                  lambda: nfa.compile_grouped(["x"]),
                  lambda: nfa.program_from_jax({}, {}),
                  lambda: sweep.device_sweep_tables(prog),
                  lambda: prefilter.device_tables(pf),
                  lambda: prefilter.class_tables(pf, [0] * 256, 8),
                  lambda: prefilter.pattern_group_onehot((0,), 1)):
        with pytest.raises(RuntimeError, match="cuda"):
            entry()
    with pytest.raises(RuntimeError, match="cuda"):
        GpuEngineFilter(["x"])
    with pytest.raises(RuntimeError, match="cuda"):
        make_pipeline(["x"])
    # The fused path: its engine, its tuner's default timing, and its
    # wrapper on a tensor that is neither on the CPU nor on a card.
    from klogs_tpu_torch.ops import nfa_kernels, tune

    monkeypatch.setenv("KLOGS_TPU_FUSED_GROUPS", "1")
    with pytest.raises(RuntimeError, match="cuda"):
        GpuEngineFilter(["x"])
    with pytest.raises(RuntimeError, match="cuda"):
        make_pipeline(["x"])
    dp, live, acc = nfa.compile_grouped(["x"], device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tune.tune_grouped(dp, live, acc, torch.zeros((8, 5), dtype=torch.int16))
    with pytest.raises(ValueError, match="device"):
        nfa_kernels.match_cls_grouped_fused(
            dp, live, acc, torch.zeros((8, 5), dtype=torch.int16,
                                       device="meta"))
    with pytest.raises(ValueError):
        make_pipeline(["x"], backend="tpu", device="cpu")
    # The ragged pack follows its tensors' device: neither CPU nor card
    # raises.
    from klogs_tpu_torch.ops import pack

    meta = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        pack.pack_rows(torch.zeros(4, dtype=torch.uint8, device="meta"),
                       meta, meta, 8, 1)
    # A follow run through the user's entry point, device=None: the
    # pipeline is built before any stream opens, and it raises.
    monkeypatch.delenv("KLOGS_TPU_FUSED_GROUPS")
    import asyncio

    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster

    fc = FakeCluster.synthetic(n_pods=1, lines_per_container=3)
    opts = cli.parse_args(["-n", "default", "-a", "-f", "--match", "x",
                           "-p", str(tmp_path)])
    stop = asyncio.Event()
    stop.set()
    with pytest.raises(RuntimeError, match="cuda"):
        asyncio.run(app.run_async(opts, backend=fc, stop=stop))
    assert os.listdir(tmp_path) == []
    # A backfill through the same entry point: the archive is found,
    # then the pipeline raises before any output file exists.
    import gzip

    arch = tmp_path.parent / (tmp_path.name + "-arch")
    arch.mkdir()
    (arch / "app.log.1.gz").write_bytes(gzip.compress(b"x y\n" * 10))
    opts = cli.parse_args(["--backfill", str(arch), "--match", "x", "-p",
                           str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="cuda"):
        asyncio.run(app.run_async(opts))
    assert os.listdir(tmp_path) == []
    # The observability flags on the same entry point: the run still
    # raises, and writes no output file and no metrics dump.
    stats = tmp_path.parent / (tmp_path.name + "-s.json")
    spans = tmp_path.parent / (tmp_path.name + "-t.jsonl")
    opts = cli.parse_args(["-n", "default", "-a", "--match", "x", "-p",
                           str(tmp_path), "--stats-json", str(stats),
                           "--trace-json", str(spans)])
    from klogs_tpu_torch.obs import trace

    try:
        with pytest.raises(RuntimeError, match="cuda"):
            asyncio.run(app.run_async(
                opts, backend=FakeCluster.synthetic(n_pods=1,
                                                    lines_per_container=3)))
    finally:
        trace.reset(None)
    assert os.listdir(tmp_path) == [] and not stats.exists()
    # filterd: its server object and its process entry point raise.
    from klogs_tpu_torch.service.server import FilterServer

    with pytest.raises(RuntimeError, match="cuda"):
        FilterServer(["x"], port=0)
    out = subprocess.run(
        [sys.executable, "-m", "klogs_tpu_torch.service", "--match", "x",
         "--port", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr
    assert "serving" not in out.stdout


def test_remote_collector_runs_without_a_card(tmp_path):
    """A --remote collector builds no engine: with device=None and no
    card it runs against a filterd (here the port's on the CPU) and
    writes the filtered files."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import asyncio

    from klogs_tpu_torch import app, cli
    from klogs_tpu_torch.cluster.fake import FakeCluster
    from klogs_tpu_torch.service.server import FilterServer

    async def go():
        server = FilterServer(["INFO"], port=0, device="cpu")
        port = await server.start()
        try:
            opts = cli.parse_args(["-n", "default", "-a", "-p",
                                   str(tmp_path), "--match", "INFO",
                                   "--remote", f"127.0.0.1:{port}"])
            return await app.run_async(opts, backend=FakeCluster.synthetic(
                n_pods=2, n_containers=1, lines_per_container=40))
        finally:
            await server.stop()

    assert asyncio.run(go()) == 0
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2
    lines = b"".join((tmp_path / f).read_bytes() for f in files).splitlines()
    assert len(lines) == 20 and all(b"INFO" in ln for ln in lines)


def test_kernel_build_refuses_without_nvcc(monkeypatch, tmp_path):
    from klogs_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at /usr/local/cuda")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.find_nvcc()


def test_kernel_build_command_targets_hopper():
    from klogs_tpu_torch.ops import _build

    cmd = _build.nvcc_command("nvcc", "k.cu", "k.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-fPIC" in cmd
    path = _build.library_path("nfa_kernels")
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    for name in ("nfa_kernels", "pack_kernels"):
        assert os.path.isfile(os.path.join(_build.CSRC, name + ".cu"))


def _run_smoke(cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py"), "rb") as f:
        (tmp_path / "chip_smoke.py").write_bytes(f.read())
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_patterns_are_the_bench_set():
    import chip_smoke

    assert chip_smoke.PATTERNS == bench.PATTERNS


def test_chip_smoke_k1024_patterns_are_the_bench_set():
    import chip_smoke

    assert chip_smoke.make_patterns(1024) == bench.make_patterns(1024)
    assert chip_smoke.make_patterns(32) == bench.PATTERNS


def test_chip_smoke_minted_needles():
    """A minted needle of member i < 992 matches that member's pattern;
    past the 1024 set it is a near miss that matches nothing."""
    import re

    import chip_smoke

    pats = chip_smoke.make_patterns(1024)
    union = re.compile("|".join(f"(?:{p})" for p in pats).encode())
    for i in (0, 1, 2, 3, 4, 5, 6, 7, 500, 991):
        assert re.search(pats[32 + i].encode(), chip_smoke.minted_needle(i))
    for i in range(992, 1000):
        assert not union.search(chip_smoke.minted_needle(i))
