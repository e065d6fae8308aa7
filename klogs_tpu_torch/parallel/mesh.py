"""The short-line engine sharded over several devices.

Counterpart of ``klogs_tpu/parallel/mesh.py``. The devices form a grid
of ``d`` data shards x ``g`` pattern shards, laid out data-major (device
``i`` is shard ``divmod(i, g)``):

- ``pattern``: the K patterns are split round-robin into ``g`` sets,
  each compiled once to its own grouped program (``filters/gpu.py``
  ``ShortLines``) with its own gate, then copied to each distinct
  device of its column;
- ``data``: a width bucket's rows, padded to a multiple of ``d``, are
  cut into ``d`` slices, one a data shard.

Each shard cuts, strips and classifies its slice of the rows from the
payload already staged on its device, through its own program's
``byte_class`` (``pack_classify_rows``, one launch), then runs its gate
and K1 or K3 on that device's current stream. The verdict of a row is
the OR of its pattern shards' verdicts: each shard's verdicts are ORed
into a zeroed uint8 vector of the bucket's rows on the first device
(the counterpart of JAX's ``pmax`` over the ``pattern`` axis; a few KiB
a batch, no kernel's work). A data shard whose slice holds only padding
launches nothing.

Across processes (``torch.distributed`` initialised, world size W, see
``parallel/distributed.py``), the mesh spans W x the local devices, in
rank order, and every rank is called with the same batch (JAX's
replicated-input rule). A rank runs its local shards only, and one
``all_reduce(MAX)`` over the world gives every rank the whole verdict
vector. The collective runs at dispatch, under a lock, so every rank
meets its collectives in its callers' dispatch order whatever the order
of the fetches.

What the JAX mesh does only to make one ``shard_map`` program
shape-uniform is not copied: the three ``impl``s, the forced uniform
(G, S), the global classifier, the stacked sweep and prefilter tables.
Nothing degrades either: a shard whose tables fail to build, or whose
launch fails, raises.
"""

import threading

import torch

from klogs_tpu_torch.filters.compiler.prefilter import compile_prefilter
from klogs_tpu_torch.filters.cpu import device_gate_choice, note_sweep_supersedes
from klogs_tpu_torch.filters.gpu import ShortLines
from klogs_tpu_torch.obs import trace
from klogs_tpu_torch.ops import nfa, tune
from klogs_tpu_torch.ui import term
from klogs_tpu_torch.utils.env import read as env_read


def choose_grid(n_devices: int, n_patterns: int) -> tuple[int, int]:
    """(data, pattern) mesh shape: give the pattern axis at most as many
    shards as there are patterns, keep it a divisor of the device count,
    and spend the rest on data parallelism. Batch is the throughput axis,
    so data gets the benefit of the doubt on ties."""
    g = 1
    for cand in range(min(n_devices, n_patterns), 0, -1):
        if n_devices % cand == 0:
            g = cand
            break
    d = n_devices // g
    # Prefer data-major splits: if the pattern axis ended up bigger than
    # data for a small pattern count, rebalance toward data.
    while g >= 2 * d and g % 2 == 0:
        g //= 2
        d *= 2
    return d, g


def split_patterns(patterns: list[str], g: int) -> list[list[str]]:
    """Round-robin so group automaton sizes stay balanced."""
    groups = [patterns[i::g] for i in range(g)]
    return [grp for grp in groups if grp]


def engine_devices(device=None) -> list[torch.device]:
    """The devices the engine factory (``filters/sink.py``) spreads a
    cuda engine over for a caller that asked for ``device``: every
    visible card for None or a bare ``"cuda"``, else that device alone.
    More than one builds a mesh."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _world() -> tuple[int, int, "str | None"]:
    """(world size, rank, backend) of the initialised process group, or
    (1, 0, None)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


class MeshEngine:
    """Pattern-sharded, data-parallel short-line engine over ``devices``
    (this process's; None means every visible card, and raises without
    one). The ``engine`` of ``GpuEngineFilter``: the filter lays out and
    stages a batch, and hands each width bucket to ``dispatch_rows``."""

    def __init__(self, patterns: list[str], ignore_case: bool = False,
                 devices=None, grid: "tuple[int, int] | None" = None):
        if devices is None:
            devices = engine_devices() or [nfa.resolve_device(None)]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [nfa.resolve_device(d) for d in devices]
        self.local_devices = list(dict.fromkeys(self.devices))
        world, rank, backend = _world()
        self._collective = backend is not None
        n_global = len(self.devices) * world
        if grid is None:
            grid = choose_grid(n_global, len(patterns))
        d, g = grid
        if d * g != n_global:
            raise ValueError(f"grid {grid} != device count {n_global}")
        self.grid = (d, g)
        groups = split_patterns(patterns, g)
        # If fewer pattern groups than shards, replicate the last: a
        # duplicate group changes nothing under any-match.
        while len(groups) < g:
            groups.append(groups[-1])
        if tune.chain_selection().get("fused"):
            term.warning(
                "KLOGS_TPU_FUSED_GROUPS=1 has no mesh per-shard variant; "
                "using the default chain instead")
        # This rank's shards: (data shard, pattern shard, device).
        first = rank * len(self.devices)
        self._local = [(*divmod(first + j, g), dev)
                       for j, dev in enumerate(self.devices)]
        # The verdicts' vector: on the first device, or on the host for
        # a gloo process group (which reduces host tensors).
        self._home = (torch.device("cpu") if backend == "gloo"
                      else self.devices[0])
        self._shards = self._build(groups, ignore_case)
        self._lock = threading.Lock()

    def _build(self, groups: list[list[str]], ignore_case: bool) -> dict:
        """{(pattern shard, device): ShortLines} for this rank's shards:
        each pattern shard compiled once, with its gate, on the first of
        its devices, then copied to the others. The gate is the single
        engine's rule over the whole set's count, on every shard or on
        none."""
        first: dict = {}
        for _, gi, dev in self._local:
            if gi not in first:
                first[gi] = ShortLines(groups[gi], ignore_case, dev)
        # Every rank compiles every pattern shard's prefilter program, so
        # all ranks decide alike.
        pfs = None
        if env_read("KLOGS_TPU_PREFILTER", "0") == "1":
            pfs = [compile_prefilter(ps, ignore_case=ignore_case)
                   for ps in groups]
            if not all(pf.usable for pf in pfs):
                pfs = None
        self.gated = pfs is not None
        self.swept = device_gate_choice(sum(map(len, groups)), self.gated,
                                        self.devices[0]) == "sweep"
        for gi, sh in first.items():
            if self.swept:
                sh._sweep_tables = sh._build_sweep(groups[gi], ignore_case)
            elif self.gated:
                sh._pf_tables = sh._prefilter_tables(pfs[gi])
        if self.swept and self.gated:
            note_sweep_supersedes(mesh=True)
            self.gated = False
        shards: dict = {}
        for _, gi, dev in self._local:
            if (gi, dev) not in shards:
                sh = first[gi]
                shards[gi, dev] = sh if sh.device == dev else sh.to(dev)
        return shards

    @property
    def data_parallelism(self) -> int:
        return self.grid[0]

    def dispatch_rows(self, staged: dict, at: int, rows: int, n_lines: int,
                      width: int) -> torch.Tensor:
        """One width bucket's verdicts: ``staged`` maps each local device
        to (metadata, payload) as ``filters/gpu.py`` ``stage`` put them
        there; the bucket's starts are ``metadata[at:at + rows]``, its
        lengths the ``rows`` after, its first ``n_lines`` rows real.
        Returns [rows] bool on the first device (on the host under gloo);
        nothing here waits on a card."""
        d, g = self.grid
        per = rows // d
        kind = {"swept": True} if self.swept else {"gated": self.gated}
        with self._lock, trace.TRACER.span("mesh.dispatch", rows=rows,
                                           grid=f"{d}x{g}", **kind):
            out = torch.zeros(rows, dtype=torch.uint8, device=self._home)
            for di, gi, dev in self._local:
                lo = di * per
                if lo >= n_lines:
                    continue
                meta, payload = staged[dev]
                starts = meta[at + lo:at + lo + per]
                lens = meta[at + rows + lo:at + rows + lo + per]
                matched, _ = self._shards[gi, dev]._match_short(
                    payload, starts, lens, width, per)
                out[lo:lo + per] |= matched.to(self._home, torch.uint8)
            if self._collective:
                torch.distributed.all_reduce(
                    out, op=torch.distributed.ReduceOp.MAX)
        return out.view(torch.bool)

    def close(self) -> None:
        """Drop every shard's device tables; the engine takes no batch
        after."""
        for sh in self._shards.values():
            sh._grouped = sh._pf_tables = sh._sweep_tables = None
            sh._onehot = None
        self._shards = {}
