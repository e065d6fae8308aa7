"""Guardrails of the port: it imports neither JAX nor the JAX package,
its CUDA entry points refuse to run without a card (no silent CPU
fallback), its kernel build refuses without nvcc, and chip_smoke.py
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


def test_cuda_entry_points_raise_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.filters.sink import make_pipeline

    with pytest.raises(RuntimeError, match="cuda"):
        GpuEngineFilter(["x"])
    with pytest.raises(RuntimeError, match="cuda"):
        make_pipeline(["x"])
    with pytest.raises(ValueError):
        make_pipeline(["x"], backend="tpu", device="cpu")


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
    assert os.path.isfile(os.path.join(_build.CSRC, "nfa_kernels.cu"))


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
