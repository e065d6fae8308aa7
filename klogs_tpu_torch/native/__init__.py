"""The collector's host work in C: build and load ``_hostops.c`` at first use.

Counterpart of ``klogs_tpu/native/__init__.py``, for the four functions
the port copies (``find_newlines``, ``join_kept_framed``, ``frame_lines``
and ``split_frame``; see ``_hostops.c``). The source is compiled by the
host's C compiler (``$CC``, else ``cc``) with ``-O3 -shared -fPIC``
against Python's headers into ``ops/build/`` (listed in ``.gitignore``),
under a name keyed by the hash of the source, the flags and the
interpreter's extension suffix: an edited source is rebuilt, an
unchanged one loaded as it is. The write is atomic (a temporary file,
then a rename), so processes that build at once never load a
half-written library. Nothing is built at import time.

A missing compiler or a failed build raises ``NativeBuildError``. There
is no quiet fallback to the numpy versions (the plain versions beside
each caller, which only the tests call), and no switch to skip or
redirect the library: the JAX loader's ``KLOGS_NO_NATIVE`` and
``KLOGS_NATIVE_SO`` are not copied.
"""

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time

from klogs_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_hostops.c")
CFLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_EXT = sysconfig.get_config_var("EXT_SUFFIX") or ".so"

_lock = threading.Lock()
_mod = None
# How the library came to be loaded in this process: its path, whether
# this process compiled it, and the compile's seconds.
build_info: "dict[str, object]" = {}


class NativeBuildError(RuntimeError):
    """The C compiler is missing or refused ``_hostops.c``."""


def library_path() -> str:
    """Where ``_hostops.c`` builds to: keyed by the source's, the flags'
    and the extension suffix's hash."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CFLAGS).encode())
    h.update(_EXT.encode())
    return os.path.join(BUILD_DIR, f"_hostops-{h.hexdigest()[:16]}{_EXT}")


def build() -> str:
    """Compile ``_hostops.c`` unless its library exists; returns the
    library's path."""
    out = library_path()
    if os.path.isfile(out):
        build_info.update(path=out, compiled=False, seconds=0.0)
        return out
    cc = os.environ.get("CC") or "cc"
    if shutil.which(cc) is None:
        raise NativeBuildError(
            f"C compiler {cc!r} not found (set CC or put cc on PATH); the "
            "port's host library is built from klogs_tpu_torch/native/"
            "_hostops.c at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    include = sysconfig.get_paths()["include"]
    cmd = [cc, *CFLAGS, f"-I{include}", SOURCE, "-o", tmp]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{cc} failed on _hostops.c: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(
            f"{cc} failed on _hostops.c (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    build_info.update(path=out, compiled=True,
                      seconds=time.perf_counter() - t0)
    return out


def hostops():
    """The loaded ``_hostops`` module, built at first use."""
    global _mod
    mod = _mod
    if mod is not None:
        return mod
    with _lock:
        if _mod is None:
            path = build()
            name = f"{__name__}._hostops"
            loader = importlib.machinery.ExtensionFileLoader(name, path)
            spec = importlib.util.spec_from_file_location(name, path,
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _mod = mod
        return _mod
