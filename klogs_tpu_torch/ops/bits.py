"""Bitset helpers for the gate's tensor code (sweep, prefilter, K3).

Words hold 32 bits in int64 lanes (values in [0, 2**32)), because
torch has no unsigned 32-bit arithmetic to speak of; ``to_int32``
narrows them to the two's-complement int32 words the kernels read.
"""

import torch

MASK32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * k mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``k`` < 2**32, without int64 overflow: the high half of ``a``
    contributes only its product's low 16 bits."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * k + (((hi * k) & 0xFFFF) << 16)) & MASK32


def or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the last axis ([..., n] -> [...]) by halving:
    log2(n) passes, zero-padded to a power of two."""
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] | x[..., h:]
    return x[..., 0]


def pack_bits(flags: torch.Tensor) -> torch.Tensor:
    """[..., G] bool -> [..., ceil(G/32)] int64 words: bit g % 32 of
    word g // 32 is flag g."""
    *lead, G = flags.shape
    GW = (G + 31) // 32
    f = torch.nn.functional.pad(flags.to(torch.int64), (0, 32 * GW - G))
    # Made on the device: a host list copied in would wait on the stream.
    weights = 1 << torch.arange(32, dtype=torch.int64, device=flags.device)
    return (f.reshape(*lead, GW, 32) * weights).sum(-1)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """[..., GW] words -> [..., n] bool (the inverse of ``pack_bits``)."""
    g = torch.arange(n, device=words.device)
    return ((words[..., g // 32] >> (g % 32)) & 1) != 0


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
