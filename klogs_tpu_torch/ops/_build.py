"""Build and load the CUDA kernels of ``ops/csrc`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with
a plain C interface, loaded with ``ctypes``. The library lands in
``ops/build/`` (listed in ``.gitignore``) under a name that carries the
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.

A missing ``nvcc`` or a failed compile raises ``KernelBuildError``;
there is no fallback to another implementation.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: "dict[str, ctypes.CDLL]" = {}
# The compiler's report (-Xptxas -v: registers, shared memory, spills)
# of each library built in this process, by source name.
build_logs: "dict[str, str]" = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, the PATH, or
    ``/usr/local/cuda``; raises KernelBuildError when there is none."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use")


def nvcc_command(nvcc: str, source: str, out: str) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", out, source]


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source's and the
    flags' hash."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library path. The write is atomic (temp file + rename),
    so concurrent builders never load a half-written library."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = nvcc_command(nvcc, os.path.join(CSRC, name + ".cu"), tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    build_logs[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
