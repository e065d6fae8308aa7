"""The pair-CNF candidate masks of the gated path, and the candidate
clustering of the JAX package's gated launch, as torch ops on the
device.

Counterpart of ``klogs_tpu/ops/prefilter.py``. It evaluates the compiled
pair-CNF (``filters/compiler/prefilter.py``, opted in by
``KLOGS_TPU_PREFILTER=1``) on a batch, per pattern:

- ``class_tables`` / ``candidate_matrix_from_cls`` — the class domain:
  the grouped program's shared classifier keeps every clause-pair side
  uniform within a class, so the clause slots are read from per-class
  member rows over the class ids the engine already computed;
- ``device_tables`` / ``candidate_matrix`` — the byte domain (256-entry
  LUTs over adjacent byte pairs), for the case ``class_tables`` refuses.

A False cell (b, p) proves pattern p cannot match line b.
``group_candidates`` reduces the per-pattern matrix to the kernel's
groups (K3, ``ops/nfa_kernels.py``, lists their set bits as
(line, group) pairs); ``cluster_candidates`` orders candidate lines
first, the counterpart of the JAX gated launch's clustering, which the
port's K3 does not need.
Every function keeps its work on the input's device and never waits on
the host.
"""

import numpy as np
import torch

from klogs_tpu_torch.filters.compiler.prefilter import PrefilterProgram
from klogs_tpu_torch.ops.bits import or_reduce
from klogs_tpu_torch.ops.nfa import resolve_device

# Elements (rows x positions x slots or words) per chunk of the masks:
# bounds their temporaries.
CHUNK_ELEMS = 1 << 24


def _by_rows(fn, B: int, per_row: int) -> torch.Tensor:
    """``fn(i, j)`` over row ranges of at most CHUNK_ELEMS elements,
    concatenated (one empty range when B is 0)."""
    rows = max(1, CHUNK_ELEMS // max(per_row, 1))
    return torch.cat([fn(i, i + rows) for i in range(0, max(B, 1), rows)])


# ---- byte domain ---------------------------------------------------------


def device_tables(pf: PrefilterProgram, device=None):
    """(lut1 [256, W], lut2 [256, W], req [P, W]) as int64 32-bit words
    on ``device`` (None means ``cuda``)."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(dev)
                 for a in (pf.lut1, pf.lut2, pf.req))


def candidate_matrix(tables, batch: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 + [B] lengths -> [B, P] bool: the line satisfies
    pattern p's whole clause requirement (some adjacent byte pair inside
    the line fires each required slot)."""
    lut1, lut2, req = tables
    B, L = batch.shape
    P, W = req.shape
    if L < 2:
        return (req == 0).all(-1)[None, :].expand(B, P).clone()
    x = batch.long()
    valid = ((torch.arange(1, L, device=batch.device)[None, :]
              < lengths.long()[:, None]))
    present = _by_rows(lambda i, j: or_reduce(torch.where(
        valid[i:j, :, None], lut1[x[i:j, :-1]] & lut2[x[i:j, 1:]],
        0).transpose(1, 2)), B, (L - 1) * W)  # [B, W] slots fired
    return _by_rows(lambda i, j: ((present[i:j, None, :] & req[None])
                                  == req[None]).all(-1), B, P * W)


# ---- class domain --------------------------------------------------------


def class_tables(pf: PrefilterProgram, byte_class, n_classes: int,
                 device=None):
    """The byte LUTs over the grouped program's shared byte classes:
    (member1 [C, S] int8, member2 [C, S] int8, req_t [S, P] int8,
    req_count [P] int32) on ``device`` (None means ``cuda``), S = slot
    count (W*32), C = ``n_classes``. Classes with no byte
    (BEGIN/END/PAD, padding) get all-zero member rows, so pairs touching
    them never fire.

    Returns None when the program is not ``usable`` (so every pattern
    here has a clause: req_count > 0) or some byte class is not uniform
    over the LUTs."""
    if not pf.usable:
        return None
    dev = resolve_device(device)
    byte_class = np.asarray(byte_class)
    lut1, lut2 = pf.lut1, pf.lut2
    W = lut1.shape[1]
    S = W * 32

    def bits(words: np.ndarray) -> np.ndarray:
        """[..., W] uint32 -> [..., W*32] 0/1 (bit b of word w is slot
        32w+b)."""
        b = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
        return b.reshape(*words.shape[:-1], W * 32)

    member1 = np.zeros((n_classes, S), dtype=np.int8)
    member2 = np.zeros((n_classes, S), dtype=np.int8)
    for c in range(n_classes):
        bs = np.nonzero(byte_class == c)[0]
        if len(bs) == 0:
            continue
        r1, r2 = lut1[bs[0]], lut2[bs[0]]
        if (lut1[bs] != r1).any() or (lut2[bs] != r2).any():
            return None  # class not LUT-uniform
        member1[c] = bits(r1)
        member2[c] = bits(r2)
    req_t = np.ascontiguousarray(bits(pf.req).T.astype(np.int8))
    req_count = req_t.sum(0, dtype=np.int32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (member1, member2, req_t, req_count))


def candidate_matrix_from_cls(tables, cls: torch.Tensor) -> torch.Tensor:
    """[B, T] class ids (``classify_chunk`` layout, sentinels included)
    -> [B, P] bool per-pattern candidate matrix. An id outside [0, C)
    fires nothing."""
    m1, m2, req_t, req_count = tables
    B, T = cls.shape
    C, S = m1.shape
    if T < 2:
        return torch.zeros((B, req_count.numel()), dtype=torch.bool,
                           device=cls.device)
    zero = torch.zeros((1, S), dtype=torch.bool, device=cls.device)
    t1, t2 = torch.cat([m1.bool(), zero]), torch.cat([m2.bool(), zero])
    c = cls.long()
    idx = torch.where((c >= 0) & (c < C), c, C)
    hits = _by_rows(lambda i, j: (t1[idx[i:j, :-1]]
                                  & t2[idx[i:j, 1:]]).any(1),
                    B, (T - 1) * S)  # [B, S]: slot fired in the line
    got = hits.float() @ req_t.float()
    return got >= req_count


# ---- reduction to groups, and clustering ---------------------------------


def pattern_group_onehot(pattern_group: "tuple[int, ...]", n_groups: int,
                         device=None) -> torch.Tensor:
    """[K, G] int8 one-hot of the grouped program's pattern -> group
    map."""
    pg = np.asarray(pattern_group, dtype=np.int64)
    onehot = (pg[:, None] == np.arange(n_groups)[None, :]).astype(np.int8)
    return torch.from_numpy(onehot).to(resolve_device(device))


def group_candidates(matrix: torch.Tensor, onehot: torch.Tensor,
                     n_patterns: int) -> torch.Tensor:
    """[B, P] per-pattern matrix + [K, G] one-hot -> [B, G] bool: the
    line is a candidate for some pattern of group g (columns past
    ``n_patterns``, if any, are dropped)."""
    return (matrix[:, :n_patterns].float() @ onehot.float()) > 0


def cluster_candidates(cand: torch.Tensor, tile: int):
    """Order lines candidates first (stable) and mark live tiles.

    Returns (order [B], inv [B], tile_live [ceil(B/tile)], n_cand [])
    int64: ``x[order]`` puts the candidates first, ``y[inv]`` undoes
    it, ``tile_live[i]`` is 1 iff tile i holds a candidate, and
    ``n_cand`` counts the candidates. A cumsum partition (destination =
    rank within its own class) and one scatter; the count stays on the
    device."""
    B = cand.shape[0]
    c = cand.long()
    n_cand = c.sum()
    pos = torch.where(cand, torch.cumsum(c, 0) - 1,
                      n_cand + torch.cumsum(1 - c, 0) - 1)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(B, device=cand.device)
    n_tiles = -(-B // tile)
    tile_live = (torch.arange(n_tiles, device=cand.device) * tile
                 < n_cand).long()
    return order, pos, tile_live, n_cand
