"""Sequence-parallel matching of huge lines: the transfer-matrix scan.

Counterpart of ``klogs_tpu/ops/seqscan.py``. The augmented automaton
(``nfa.augment``: inject folded into the ``live`` self-loop, accept into
the absorbing ``acc`` sink) makes the per-byte step linear over the
boolean semiring,

    v_t = v_{t-1} @ A[c_t],   A[c][i, j] = follow[i, j] and char_mask[c][j],

so a run of bytes folds into one S x S transfer matrix by a log-depth
tree of batched products, and runs compose:

- ``tile_transfer_matrices``: class ids [N, T0] -> the N runs' transfer
  matrices [N, S, S], 0/1 int8 as JAX's;
- ``_scan_chunked``: lines' class ids cut into chunks of tiles -> final
  state vectors, one chunk's step matrices materialised at a time;
- ``match_line_scan`` and ``match_lines_scan``: one line, or a batch of
  lines grouped by chunk count -> verdicts (the batch's as a bool tensor
  on the program's device);
- ``match_line_sharded``: one line's chunks in contiguous spans over
  several devices, each span folded to one matrix, the matrices composed
  in device order on the first device.

The products are plain ``torch.matmul``, as JAX leaves them to XLA
outside any Pallas kernel: fp16 operands on a card (counts up to 2048
are exact in fp16, and the products accumulate in fp32), float32 on the
CPU; every product is tested ``> 0`` in place. The step matrices of a
run are stacked in bit-reversed time order, so each level of the tree
multiplies the stack's first half by its second, two contiguous halves
with no copy. The step matrices are built on the device from the class
ids, and the class ids from the line's bytes there.

Peak memory is the step matrices of one call (the tree's levels after
them hold half as many, then a quarter...): ``step_bytes_budget`` bounds
them at the element size the device uses. Unlike JAX, chunk counts and
batch sizes are not padded to powers of two: PyTorch keeps no compiled
program per shape, and a pad tile is work for nothing. A chunk's tile
count stays a power of two, so a chunk folds as one run.
"""

import dataclasses

import numpy as np
import torch

from klogs_tpu_torch.ops.nfa import TorchProgram, resolve_device

DEFAULT_TILE_T = 512

# At most this many bytes of step matrices materialised per tree (per
# device in ``match_line_sharded``); a line longer than that folds chunk
# by chunk into the carry.
DEFAULT_STEP_BYTES_BUDGET = 128 << 20


def _dtype(device: torch.device) -> torch.dtype:
    """The products' operand type: fp16 on a card (the tensor cores), else
    float32."""
    return torch.float16 if device.type == "cuda" else torch.float32


def _elem_bytes(device: torch.device) -> int:
    return torch.empty((), dtype=_dtype(device)).element_size()


def _tiles_per_chunk(tile_t: int, n_states: int,
                     budget: int = DEFAULT_STEP_BYTES_BUDGET,
                     elem_bytes: int = 1) -> int:
    """Tiles whose step matrices (``elem_bytes`` an entry) fit
    ``budget``; at least one."""
    return max(1, budget // (tile_t * n_states * n_states * elem_bytes))


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _bit_reversal(n: int, device: torch.device) -> torch.Tensor:
    """[n] int64: position i holds time ``i`` with its log2(n) bits
    reversed (n a power of two)."""
    k = n.bit_length() - 1
    i = np.arange(n)
    r = np.zeros(n, dtype=np.int64)
    for b in range(k):
        r |= ((i >> b) & 1) << (k - 1 - b)
    return torch.from_numpy(r).to(device)


def _tables(prog: TorchProgram):
    """(follow [S, S], char_mask [C, S], bit reversals by length) of
    ``prog`` in the products' type, built once on its device."""
    tabs = prog.cache.get("seqscan")
    if tabs is None:
        dt = _dtype(prog.device)
        tabs = (prog.follow.to(dt), prog.char_mask.to(dt), {})
        prog.cache["seqscan"] = tabs
    return tabs


def _bmm_bool(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched boolean product of 0/1 matrices, 0/1 in the operands'
    type."""
    p = torch.matmul(a, b)
    return torch.gt(p, 0, out=p)


def _transfer(prog: TorchProgram, cls: torch.Tensor) -> torch.Tensor:
    """Class ids [N, T0] (T0 a power of two) on the program's device ->
    each row's ordered product of step matrices, [N, S, S] 0/1 in the
    products' type."""
    N, T0 = cls.shape
    if T0 & (T0 - 1):
        raise ValueError(f"a run of {T0} steps: must be a power of two")
    S = prog.n_states
    follow, mask, rev = _tables(prog)
    perm = rev.get(T0)
    if perm is None:
        perm = rev[T0] = _bit_reversal(T0, prog.device)
    # Time-major, in bit-reversed time order: level by level the first
    # half of the stack times the second is the ordered pairwise product.
    ids = cls.index_select(1, perm).t().reshape(-1)
    a = follow[None] * mask.index_select(0, ids)[:, None, :]  # [T0*N, S, S]
    a = a.view(T0, N, S, S)
    while a.shape[0] > 1:
        h = a.shape[0] // 2
        a = _bmm_bool(a[:h], a[h:])
    return a[0]


def tile_transfer_matrices(prog: TorchProgram,
                           cls: torch.Tensor) -> torch.Tensor:
    """Class ids [N, T0] -> transfer matrices [N, S, S] int8 0/1, each
    the ordered product of its tile's step matrices, built by a log-depth
    pairwise tree. T0 must be a power of two (pad with ``pad_class``: its
    step is absorbing for live/acc and kills every other state, which is
    the meaning of positions past the end of a line).

    Materialises N * T0 step matrices: callers bound N * T0
    (``_tiles_per_chunk``, ``DEFAULT_STEP_BYTES_BUDGET``)."""
    return _transfer(prog, cls.to(prog.device)).to(torch.int8)


def _classes(prog: TorchProgram, payload: torch.Tensor, starts: torch.Tensor,
             lens: torch.Tensor, T: int) -> torch.Tensor:
    """Class ids [n, T] int32 of the lines at ``starts`` with ``lens``
    (int64, on the payload's device) in ``payload`` (uint8): BEGIN, the
    body, END, then PAD (the first PAD is the accept latch); T must
    exceed every length + 2."""
    t = torch.arange(T, device=payload.device)[None, :]
    n = lens[:, None]
    last = max(payload.numel() - 1, 0)
    pos = (starts[:, None] + t - 1).clamp_(0, last)
    body = prog.byte_class.index_select(
        0, payload.index_select(0, pos.reshape(-1)).to(torch.int32)
    ).view(pos.shape) if payload.numel() else torch.zeros_like(pos)
    cls = torch.where((t >= 1) & (t <= n), body.to(torch.int32),
                      torch.full_like(body, prog.pad_class, dtype=torch.int32))
    cls.masked_fill_(t == 0, prog.begin_class)
    cls.masked_fill_(t == n + 1, prog.end_class)
    return cls


def _to_device(lines: list, device: torch.device, *extra: np.ndarray):
    """(payload uint8, starts int64, lens int64, *extra int64) of
    ``lines`` on ``device``, from one host buffer (pinned for a card, and
    copied without waiting), and the lengths on the host."""
    lens = np.fromiter(map(len, lines), dtype=np.int64, count=len(lines))
    meta = np.concatenate([np.cumsum(lens) - lens, lens, *extra])
    head = meta.nbytes
    host = torch.empty(head + int(lens.sum()), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    buf[:head] = meta.astype(np.int64).view(np.uint8)
    buf[head:] = np.frombuffer(b"".join(lines), dtype=np.uint8)
    t = host.to(device, non_blocking=True) if device.type == "cuda" else host
    meta_d = t[:head].view(torch.int64)
    cuts = np.cumsum([len(lens), len(lens)] + [len(e) for e in extra])
    return (t[head:], *torch.tensor_split(meta_d, cuts[:-1].tolist()), lens)


def classify_line(prog: TorchProgram, line: bytes,
                  tile_t: int) -> torch.Tensor:
    """Class ids [T] int32 of one line on the program's device, with
    BEGIN, END and the latch, padded with PAD to a multiple of ``tile_t``
    (a power of two)."""
    payload, starts, lens, _ = _to_device([line], prog.device)
    T = -(-(len(line) + 3) // tile_t) * tile_t
    return _classes(prog, payload, starts, lens, T)[0]


def _start(prog: TorchProgram, live: int, n: int) -> torch.Tensor:
    """[n, 1, S] one-hot on ``live`` in the products' type."""
    v = torch.zeros((n, 1, prog.n_states), dtype=_dtype(prog.device),
                    device=prog.device)
    v[:, 0, live] = 1
    return v


def _scan_chunked(prog: TorchProgram, cls: torch.Tensor,
                  live: int) -> torch.Tensor:
    """Class ids [..., n_chunks, tiles_per_chunk, tile_t] -> final state
    vectors [..., S] int8: the leading axes are lines advancing together
    (JAX's ``_scan_chunked`` for one line, ``_scan_chunked_batch`` for
    several). A chunk's tiles fold as one run (their count times
    ``tile_t`` a power of two), and the carry through it; peak memory is
    one chunk's step matrices for all the lines."""
    *lead, n_chunks, tpc, tile_t = cls.shape
    cls = cls.to(prog.device).reshape(-1, n_chunks, tpc * tile_t)
    v = _start(prog, live, cls.shape[0])
    for k in range(n_chunks):
        v = _bmm_bool(v, _transfer(prog, cls[:, k]))
    return v[:, 0].to(torch.int8).reshape(*lead, prog.n_states)


def _plan(S: int, n_lines: int, max_tiles: int, tile_t: int, budget: int,
          elem_bytes: int) -> tuple[int, int]:
    """(tiles a chunk, lines a fold) of a batch of ``n_lines`` whose
    longest needs ``max_tiles``: the budget split across the lines (at
    least one tile a line), the chunk a power of two of tiles and no
    longer than the longest line needs, and no more lines a fold than
    the budget holds at that chunk."""
    tile_bytes = tile_t * S * S * elem_bytes
    per_line = max(budget // n_lines, tile_bytes)
    tpc = min(_pow2_floor(_tiles_per_chunk(tile_t, S, per_line, elem_bytes)),
              _pow2_ceil(max_tiles))
    return tpc, max(1, budget // (tpc * tile_bytes))


def _chunk_counts(n_tiles: np.ndarray, tpc: int, pad: bool) -> np.ndarray:
    """Each line's chunk count, the key it is grouped by: its tiles in
    chunks of ``tpc``, with ``pad`` rounded up to a power of two (JAX's
    rule, which merges lines of near lengths into one fold), else not.
    PAD tiles are the identity on live and acc."""
    n = -(-n_tiles // tpc)
    if pad:
        n = 1 << np.ceil(np.log2(n)).astype(np.int64)
    return n


def match_lines_scan(prog: TorchProgram, live: int, acc: int,
                     lines: list, tile_t: int = DEFAULT_TILE_T,
                     step_bytes_budget: int = DEFAULT_STEP_BYTES_BUDGET,
                     ) -> torch.Tensor:
    """Batched sequence-parallel matching of huge lines -> [N] bool on the
    program's device, enqueued without waiting on it. Lines are grouped
    by chunk count and each group runs as one batched fold; the budget is
    split across the lines of the call, and a fold holds no more lines
    than the budget allows at that chunk, so peak memory stays at
    ``step_bytes_budget`` for the whole call. Where a fold holds several
    lines, chunk counts are padded to a power of two (``PERF.md`` §6:
    several lines then share one fold); a lone long line is never
    padded."""
    if tile_t & (tile_t - 1):
        raise ValueError("tile_t must be a power of two")
    n = len(lines)
    if n == 0 or prog.match_all:
        return torch.full((n,), prog.match_all, dtype=torch.bool,
                          device=prog.device)
    n_tiles = -(-(np.fromiter(map(len, lines), np.int64, n) + 3) // tile_t)
    tpc, max_n = _plan(prog.n_states, n, int(n_tiles.max()), tile_t,
                       step_bytes_budget, _elem_bytes(prog.device))
    n_chunks = _chunk_counts(n_tiles, tpc, max_n > 1)
    order = np.argsort(n_chunks, kind="stable")
    payload, starts, lens, order_d, _ = _to_device(lines, prog.device, order)
    out = torch.empty(n, dtype=torch.bool, device=prog.device)
    at = 0
    for nc, count in zip(*np.unique(n_chunks, return_counts=True)):
        for lo in range(at, at + count, max_n):
            sub = order_d[lo:min(lo + max_n, at + count)]
            cls = _classes(prog, payload, starts.index_select(0, sub),
                           lens.index_select(0, sub), int(nc) * tpc * tile_t)
            v = _scan_chunked(prog, cls.view(len(sub), int(nc), tpc, tile_t),
                              live)
            out.index_copy_(0, sub, v[:, acc] != 0)
        at += count
    return out


def match_line_scan(prog: TorchProgram, live: int, acc: int, line: bytes,
                    tile_t: int = DEFAULT_TILE_T,
                    step_bytes_budget: int = DEFAULT_STEP_BYTES_BUDGET,
                    ) -> bool:
    """Single-device sequence-parallel match of one line (its verdict on
    the host): per-chunk transfer matrices by the batched tree, folded
    into the carry chunk by chunk, so peak memory is bounded by
    ``step_bytes_budget`` whatever the line's length."""
    return bool(match_lines_scan(prog, live, acc, [line], tile_t,
                                 step_bytes_budget)[0])


def _on(prog: TorchProgram, device: torch.device) -> TorchProgram:
    """``prog`` on ``device``: copied there once, kept in its cache."""
    if device == prog.device:
        return prog
    key = ("seqscan_on", device)
    moved = prog.cache.get(key)
    if moved is None:
        moved = dataclasses.replace(prog, cache={}, **{
            f.name: getattr(prog, f.name).to(device)
            for f in dataclasses.fields(prog)
            if isinstance(getattr(prog, f.name), torch.Tensor)})
        prog.cache[key] = moved
    return moved


def match_line_sharded(prog: TorchProgram, live: int, acc: int, line: bytes,
                       devices=None, tile_t: int = DEFAULT_TILE_T,
                       step_bytes_budget: int = DEFAULT_STEP_BYTES_BUDGET,
                       ) -> bool:
    """Sequence-parallel across devices: the line's chunks in contiguous
    equal spans over ``devices`` (None: ``parallel.mesh.engine_devices``
    of the program's device type, so every visible card); each device
    folds its span into one [S, S] transfer matrix, chunk by chunk (peak
    memory ``step_bytes_budget`` a device), the chunks enqueued on the
    devices in turn; the D matrices compose in device order on the first
    device, then ``v0 @ M``. A chunk is planned as for one line of a
    device's share, and the chunk count rounded up to a multiple of D
    with PAD tiles (the identity on live and acc)."""
    if devices is None:
        # Deferred: parallel.mesh sits above ops (it imports the engine,
        # filters.gpu).
        from klogs_tpu_torch.parallel.mesh import engine_devices

        devices = engine_devices(prog.device.type)
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("match_line_sharded needs at least one device")
    D = len(devices)
    n_tiles = -(-(len(line) + 3) // tile_t)
    tpc, _ = _plan(prog.n_states, 1, -(-n_tiles // D), tile_t,
                   step_bytes_budget, max(map(_elem_bytes, devices)))
    chunk = tpc * tile_t
    per = -(-n_tiles // (tpc * D))  # chunks a device
    cls = classify_line(prog, line, chunk)
    cls = torch.cat([cls, cls.new_full((D * per * chunk - cls.numel(),),
                                       prog.pad_class)]).view(D, per, chunk)
    progs = [_on(prog, d) for d in devices]
    spans = [cls[d].to(dev) for d, dev in enumerate(devices)]
    mats: list = [None] * D
    for k in range(per):
        for d in range(D):
            m = _transfer(progs[d], spans[d][k:k + 1])
            mats[d] = m if mats[d] is None else _bmm_bool(mats[d], m)
    total = mats[0]
    for m in mats[1:]:
        total = _bmm_bool(total, m.to(devices[0], total.dtype))
    v = _bmm_bool(_start(progs[0], live, 1), total)
    return bool(v[0, 0, acc] > 0) or prog.match_all
