"""Device literal sweep: the factor-index gate of the thousand-pattern
path, as torch tensor ops on the device.

Counterpart of ``klogs_tpu/ops/sweep.py`` (XLA there, so plain tensor
code here, not a hand kernel). It evaluates the ``SweepProgram`` tables
(``filters/compiler/index.py``) over a packed ``[B, L]`` byte batch and
gives, per (line, kernel group), whether some guard factor of a pattern
in that group occurs inside the line: a necessary condition for the
group to match, exact (the same survivors as the host sweep) and with
no host round trip. Stages, all dense:

1. rolling codes: the little-endian 4-byte code at every position, from
   four shifted slices of the zero-padded rows; the wide tier's key
   mixes it with the code four bytes ahead (one multiply, one xor);
2. two-tier hash probe: ``max_probe`` rounds of gather + compare into
   each tier's open-addressed table;
3. masked word verify: each of a matched key's (at most ``max_bucket``)
   entries compares its factor's words, masked, against the rolling
   codes at the factor's start, with the line bounds;
4. group bitset: verified hits OR their factor's group words into the
   line's ``[GW]`` accumulator, which starts at ``always_mask``.

``sweep_group_bits`` returns the packed ``[B, GW]`` words K3 consumes;
``sweep_group_candidates`` the ``[B, G]`` bool matrix. Rows are
processed in chunks of at most ``CHUNK_ELEMS`` positions, which bounds
the int64 temporaries. Nothing here synchronises with the host.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from klogs_tpu_torch.filters.compiler.index import SweepProgram, SweepTier
from klogs_tpu_torch.ops.bits import mul32, or_reduce, unpack_bits
from klogs_tpu_torch.ops.nfa import resolve_device

# Fibonacci multiply fold, shared with the index's tables: hash slot =
# high log2(H) bits of the wrapping 32-bit product.
_FIB = 2654435761
# Positions (rows x width) per chunk of the sweep: ~32 MB per int64
# temporary.
CHUNK_ELEMS = 1 << 22


@dataclass
class DeviceTier:
    """One probe tier's tables on the device (int64 codes, int64
    indices) and its static loop bounds."""

    slot_key: torch.Tensor  # [H]
    slot_eid: torch.Tensor  # [H], -1 = empty
    start: torch.Tensor  # [E+1] bucket starts
    fid: torch.Tensor  # [NE]
    anchor: torch.Tensor  # [NE]
    max_probe: int
    max_bucket: int
    n_words: int


@dataclass
class SweepTables:
    """A ``SweepProgram`` as tensors on one device."""

    narrow: DeviceTier
    wide: DeviceTier
    fac_len: torch.Tensor  # [F]
    fac_words: torch.Tensor  # [F, W] 32-bit words in int64
    fac_wmask: torch.Tensor  # [F, W]
    fac_groups: torch.Tensor  # [F, GW]
    always_mask: torch.Tensor  # [GW]
    n_groups: int

    @property
    def device(self) -> torch.device:
        return self.fac_len.device


def device_sweep_tables(prog: SweepProgram, device=None) -> SweepTables:
    """Move a packed ``SweepProgram`` to ``device`` (``resolve_device``:
    None means ``cuda``)."""
    dev = resolve_device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)

    def tier(x: SweepTier) -> DeviceTier:
        return DeviceTier(t(x.slot_key), t(x.slot_eid), t(x.bucket_start),
                          t(x.fid), t(x.anchor), x.max_probe, x.max_bucket,
                          x.n_words)

    return SweepTables(
        narrow=tier(prog.narrow), wide=tier(prog.wide),
        fac_len=t(prog.fac_len), fac_words=t(prog.fac_words),
        fac_wmask=t(prog.fac_wmask), fac_groups=t(prog.fac_groups),
        always_mask=t(prog.always_mask), n_groups=prog.n_groups)


def _rolling_codes(batch: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 -> [B, L+4] int64: the little-endian 4-byte code at
    every position (positions L..L+3 read zero padding, so the wide
    tier's +4 lookup stays in bounds)."""
    L = batch.shape[1]
    x = F.pad(batch, (0, 8)).to(torch.int64)
    n = L + 4
    return (x[:, :n] | (x[:, 1:n + 1] << 8) | (x[:, 2:n + 2] << 16)
            | (x[:, 3:n + 3] << 24))


def _probe_tier(keys: torch.Tensor, roll: torch.Tensor, tier: DeviceTier,
                st: SweepTables, lens: torch.Tensor,
                acc: torch.Tensor) -> None:
    """One tier's hash probe, bucket walk and masked word verify over
    the [B, L] per-position ``keys``, OR-ing verified factors' group
    words into ``acc`` ([B, GW], in place)."""
    H = tier.slot_key.numel()
    E = tier.start.numel() - 1
    if tier.max_probe == 0 or E <= 0:
        return
    L = keys.shape[1]
    h = mul32(keys, _FIB) >> (32 - (H.bit_length() - 1))
    eid = torch.full_like(keys, -1)
    for j in range(tier.max_probe):
        s = (h + j) & (H - 1)
        hit = (tier.slot_key[s] == keys) & (tier.slot_eid[s] >= 0)
        eid = torch.where(hit, tier.slot_eid[s], eid)  # keys unique
    found = eid >= 0
    eidc = eid.clamp(0, E - 1)
    b_lo, b_hi = tier.start[eidc], tier.start[eidc + 1]
    pos = torch.arange(L, device=keys.device)[None, :]
    NE = tier.fid.numel()
    for j in range(tier.max_bucket):
        e = b_lo + j
        ec = e.clamp(0, NE - 1)
        f = tier.fid[ec]
        begin = pos - tier.anchor[ec]
        ver = (found & (e < b_hi) & (begin >= 0)
               & (begin + st.fac_len[f] <= lens))
        bc = begin.clamp(0, L - 1)
        for w in range(tier.n_words):
            cw = torch.gather(roll, 1, (bc + 4 * w).clamp(max=L + 3))
            ver &= (cw & st.fac_wmask[f, w]) == st.fac_words[f, w]
        hits = torch.where(ver[..., None], st.fac_groups[f], 0)
        acc |= or_reduce(hits.transpose(1, 2))


def _sweep_rows(st: SweepTables, batch: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    B, L = batch.shape
    acc = st.always_mask[None, :].repeat(B, 1)
    roll = _rolling_codes(batch)
    codes = roll[:, :L]
    lens = lengths.to(torch.int64)[:, None]
    _probe_tier(codes, roll, st.narrow, st, lens, acc)
    # Wide tier key: the Fibonacci mix of this code and the one 4 bytes
    # ahead — the chained half-window conjunction as one 32-bit key.
    wkey = mul32(codes, _FIB) ^ roll[:, 4:L + 4]
    _probe_tier(wkey, roll, st.wide, st, lens, acc)
    return acc


def sweep_group_bits(st: SweepTables, batch: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 rows + [B] lengths -> [B, GW] int64 group words (bit
    g % 32 of word g // 32: group g is a candidate for the line), on the
    batch's device. Rows of length 0 (batch padding) get only
    ``always_mask``."""
    if batch.dim() != 2 or batch.dtype != torch.uint8:
        raise ValueError(f"batch must be [B, L] uint8, got "
                         f"{tuple(batch.shape)} {batch.dtype}")
    if batch.device != st.device or lengths.device != st.device:
        raise ValueError(f"batch on {batch.device}, lengths on "
                         f"{lengths.device}, tables on {st.device}")
    B, L = batch.shape
    if B == 0 or L == 0 or (st.narrow.max_probe == 0
                            and st.wide.max_probe == 0):
        return st.always_mask[None, :].repeat(B, 1)
    rows = max(1, CHUNK_ELEMS // L)
    return torch.cat([_sweep_rows(st, batch[i:i + rows], lengths[i:i + rows])
                      for i in range(0, B, rows)])


def sweep_group_candidates(st: SweepTables, batch: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 rows + [B] lengths -> [B, G] bool: True where some
    guard factor of group g occurs inside the line, or g is an
    always-candidate group."""
    return unpack_bits(sweep_group_bits(st, batch, lengths), st.n_groups)


def sweep_span_attrs(st: SweepTables) -> "dict[str, int]":
    """The table shape (never content) a ``device.sweep`` span carries:
    groups, factors and each tier's hash slots."""
    return {
        "sweep_groups": int(st.n_groups),
        "sweep_factors": int(st.fac_len.shape[0]),
        "sweep_narrow_slots": int(st.narrow.slot_key.shape[-1]),
        "sweep_wide_slots": int(st.wide.slot_key.shape[-1]),
    }
