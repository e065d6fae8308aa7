"""The port's process-group bring-up (``klogs_tpu_torch/parallel/
distributed.py``) and the mesh across processes.

- The JAX package's four contract cases (``tests/test_distributed.py``)
  against a recorded ``torch.distributed.init_process_group``: the
  environment's arguments reach it, explicit arguments win, one process
  is a no-op, and ``process_id=0`` is not taken as missing.
- A live run: two processes (2 ranks x 2 local CPU devices = 4 global)
  meet over gloo through the environment, build one ``MeshEngine`` and
  give the same verdicts as each other, as the JAX package's
  single-process ``MeshEngine`` and as ``RegexFilter``. The worker is
  ``_worker`` below, each process started with a timeout.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from klogs_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERNS = ["ERROR", r"code=50[34]", r"retry \d+/\d+", r"^kernel:"]


def batch_lines(n: int = 64, seq0: int = 0) -> list[bytes]:
    return [{
        0: b"all quiet seq=%d",
        1: b"an ERROR happened seq=%d",
        2: b"code=503 backoff retry %d/9",
        3: b"kernel: oops %d",
        4: b"xx kernel: not anchored %d",
    }[i % 5] % (seq0 + i) for i in range(n)]


@pytest.fixture
def record(monkeypatch):
    calls = []

    def fake_init(backend=None, init_method=None, world_size=-1, rank=-1,
                  timeout=None):
        calls.append((init_method, world_size, rank, backend))
        assert isinstance(timeout, datetime.timedelta)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    return calls


def test_single_process_is_noop(record, monkeypatch):
    for var in ("KLOGS_COORDINATOR", "KLOGS_NUM_PROCESSES",
                "KLOGS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert record == []
    monkeypatch.setenv("KLOGS_NUM_PROCESSES", "1")
    distributed.initialize()
    assert record == []


def test_env_driven_bringup(record, monkeypatch):
    monkeypatch.setenv("KLOGS_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("KLOGS_NUM_PROCESSES", "16")
    monkeypatch.setenv("KLOGS_PROCESS_ID", "3")
    distributed.initialize()
    # No card here: gloo.
    assert record == [("tcp://10.0.0.1:8476", 16, 3, "gloo")]


def test_explicit_args_win_over_env(record, monkeypatch):
    monkeypatch.setenv("KLOGS_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("KLOGS_NUM_PROCESSES", "16")
    monkeypatch.setenv("KLOGS_PROCESS_ID", "3")
    distributed.initialize("other:1234", 4, 0, backend="nccl")
    assert record == [("tcp://other:1234", 4, 0, "nccl")]


def test_process_id_zero_not_treated_as_missing(record, monkeypatch):
    # `process_id=0` is falsy; the param plumbing must not fall through
    # to the env for the coordinator process.
    monkeypatch.setenv("KLOGS_PROCESS_ID", "7")
    distributed.initialize("c:1", 2, 0)
    assert record == [("tcp://c:1", 2, 0, "gloo")]


def test_initialised_group_is_left_alone(record, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    distributed.initialize("c:1", 2, 1)
    assert record == []


def _worker(out_path: str) -> None:
    """One rank of the live run: the environment's process group, a
    mesh over this process's two CPU devices (four in the world), two
    batches dispatched and fetched in the other order, the verdicts
    written to ``out_path`` as JSON."""
    from klogs_tpu_torch.filters.gpu import GpuEngineFilter
    from klogs_tpu_torch.parallel.mesh import MeshEngine

    distributed.initialize(timeout_s=60)
    cpu = torch.device("cpu")
    eng = MeshEngine(PATTERNS, devices=[cpu, cpu])
    f = GpuEngineFilter(PATTERNS, device="cpu", engine=eng)
    first = f.dispatch(batch_lines())
    second = f.dispatch(batch_lines(21, seq0=64))
    masks = [f.fetch(second), f.fetch(first)][::-1]
    with open(out_path, "w") as fh:
        json.dump({"rank": torch.distributed.get_rank(),
                   "world": torch.distributed.get_world_size(),
                   "backend": torch.distributed.get_backend(),
                   "grid": list(eng.grid),
                   "local": [[di, gi] for di, gi, _ in eng._local],
                   "masks": masks}, fh)
    torch.distributed.destroy_process_group()


def test_live_two_process_mesh_match(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, outs = [], []
    for rank in (0, 1):
        out = tmp_path / f"rank{rank}.json"
        outs.append(out)
        env = dict(os.environ)
        env.update({"KLOGS_COORDINATOR": f"127.0.0.1:{port}",
                    "KLOGS_NUM_PROCESSES": "2",
                    "KLOGS_PROCESS_ID": str(rank),
                    "OMP_NUM_THREADS": "1"})
        code = ("from tests.test_torch_distributed import _worker; "
                f"_worker({str(out)!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fail = []
    for rank, p in enumerate(procs):
        try:
            stdout, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        if p.returncode != 0:
            fail.append(f"rank{rank} rc={p.returncode}: "
                        f"{stdout.decode()[-1500:]}")
    assert not fail, "\n".join(fail)

    docs = [json.loads(out.read_text()) for out in outs]
    assert [d["rank"] for d in docs] == [0, 1]
    assert all(d["world"] == 2 and d["backend"] == "gloo" for d in docs)
    # choose_grid(4 devices, 4 patterns): 2 data x 2 pattern shards, rank
    # 0 holds global devices 0 and 1, rank 1 devices 2 and 3.
    assert [d["grid"] for d in docs] == [[2, 2]] * 2
    assert docs[0]["local"] == [[0, 0], [0, 1]]
    assert docs[1]["local"] == [[1, 0], [1, 1]]
    assert docs[0]["masks"] == docs[1]["masks"]

    import jax

    from klogs_tpu.filters.cpu import RegexFilter
    from klogs_tpu.filters.tpu import NFAEngineFilter
    from klogs_tpu.parallel.mesh import MeshEngine as JaxMeshEngine

    jf = NFAEngineFilter(PATTERNS, engine=JaxMeshEngine(
        PATTERNS, devices=jax.devices()[:4]))
    for mask, lines in zip(docs[0]["masks"],
                           [batch_lines(), batch_lines(21, seq0=64)]):
        assert mask == jf.match_lines(lines)
        assert mask == RegexFilter(PATTERNS).match_lines(lines)
