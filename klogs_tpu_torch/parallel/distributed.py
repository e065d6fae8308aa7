"""The process group for a mesh across processes.

Counterpart of ``klogs_tpu/parallel/distributed.py``. One process with
several cards needs nothing: ``parallel/mesh.py`` ``engine_devices``
lists every visible card and ``MeshEngine`` spans them. Across processes
(hosts, or a card each), every process calls ``initialize()`` before it
builds its engine; a ``MeshEngine`` then spans the world's devices,
rank by rank, and ORs the pattern shards' verdicts with one
``all_reduce`` a sub-batch.

Environment-driven, with the JAX package's names (explicit arguments
win):
  KLOGS_COORDINATOR   host:port of rank 0's rendezvous (else
                      torch.distributed's ``env://`` defaults apply)
  KLOGS_NUM_PROCESSES total process count
  KLOGS_PROCESS_ID    this process's rank

The backend is ``nccl`` where the process sees a card and ``gloo``
elsewhere; ``backend=`` overrides it (two ranks sharing one card must
use gloo: NCCL refuses two ranks on one GPU). Nothing in the CLI calls
this, as in the JAX package.
"""

import datetime

import torch

from klogs_tpu_torch.utils.env import read as _env_read

# How long the rendezvous waits for every rank before it raises.
DEFAULT_TIMEOUT_S = 120.0


def initialize(coordinator: "str | None" = None,
               num_processes: "int | None" = None,
               process_id: "int | None" = None,
               backend: "str | None" = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Idempotent ``torch.distributed`` bring-up. No-ops when the
    environment describes a single process, or when the process group
    is already up."""
    coordinator = coordinator or _env_read("KLOGS_COORDINATOR")
    num_processes = num_processes or _int_env("KLOGS_NUM_PROCESSES")
    process_id = (process_id if process_id is not None
                  else _int_env("KLOGS_PROCESS_ID"))
    if num_processes in (None, 1) or torch.distributed.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}" if coordinator else None,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def _int_env(name: str) -> "int | None":
    v = _env_read(name)
    return int(v) if v else None
