"""The ragged pack: a framed payload cut into zero-padded rows, on the
device.

The JAX engine feeds its kernels through a host packer
(``klogs_tpu/native/_hostops.c`` ``pack_classify_framed``): every width
bucket's rows are cut out of the contiguous payload on the host, and
the rows cross to the device. Here the payload and its per-line starts
and lengths cross once per batch, and ``pack_rows`` cuts each bucket's
rows, and each chunk of the long lines, from it where it already lies:

    row r = payload[starts[r] + skip : starts[r] + skip + clamp(lens[r] - skip, 0, width)]

zero-padded to ``width``; rows at or past ``len(starts)`` are all zero
(batch-bucket padding). ``skip = 0`` serves the width buckets, ``skip =
k * chunk_bytes`` chunk k of the long lines.

A tensor on the CPU runs ``pack_rows_plain``; a CUDA tensor launches
``pack_rows_kernel`` from ``ops/csrc/pack_kernels.cu`` or raises.
Launches count in ``nfa_kernels.LAUNCHES`` under ``PACK``.
"""

import ctypes
import threading

import torch

from klogs_tpu_torch.ops import nfa_kernels
from klogs_tpu_torch.ops.nfa_kernels import PACK

_lib = None
_lib_lock = threading.Lock()


def _library():
    """The built pack library, with its C signatures declared."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from klogs_tpu_torch.ops import _build

            lib = _build.load("pack_kernels")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.klogs_pack_rows.argtypes = [p, p, p, i, i, i,
                                            ctypes.c_longlong, p, p, i]
            lib.klogs_pack_rows.restype = i
            lib.klogs_pack_error_string.argtypes = [i]
            lib.klogs_pack_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_args(payload: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, width: int, rows: int, skip: int) -> None:
    if payload.dim() != 1 or payload.dtype != torch.uint8:
        raise TypeError(f"payload must be 1-D uint8, got {payload.dtype} "
                        f"{tuple(payload.shape)}")
    if (starts.dim() != 1 or starts.shape != lens.shape
            or {starts.dtype, lens.dtype} != {torch.int64}):
        raise TypeError("starts and lens must be 1-D int64 of one length")
    if not payload.device == starts.device == lens.device:
        raise ValueError(f"payload on {payload.device}, starts on "
                         f"{starts.device}, lens on {lens.device}")
    if width <= 0 or rows < starts.shape[0] or skip < 0:
        raise ValueError(f"width={width}, rows={rows} for "
                         f"{starts.shape[0]} lines, skip={skip}")


def pack_rows(payload: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
              width: int, rows: int, skip: int = 0) -> torch.Tensor:
    """[P] uint8 payload + [n] int64 starts and lengths -> [rows, width]
    uint8: row r holds line r's bytes from ``skip`` on, at most
    ``width`` of them, zero-padded; rows n..rows-1 are zero. Nothing
    waits on the host."""
    _check_args(payload, starts, lens, width, rows, skip)
    if payload.device.type == "cpu":
        return pack_rows_plain(payload, starts, lens, width, rows, skip)
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    dev = payload.device
    payload = payload.contiguous()
    starts, lens = starts.contiguous(), lens.contiguous()
    out = torch.empty((rows, width), dtype=torch.uint8, device=dev)
    err = _library().klogs_pack_rows(
        payload.data_ptr(), starts.data_ptr(), lens.data_ptr(),
        starts.shape[0], width, rows, skip, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    nfa_kernels._count(PACK)
    if err != 0:
        msg = _library().klogs_pack_error_string(err).decode()
        raise RuntimeError(f"{PACK} launch failed: cudaError {err} ({msg})")
    return out


def pack_rows_plain(payload: torch.Tensor, starts: torch.Tensor,
                    lens: torch.Tensor, width: int, rows: int,
                    skip: int = 0) -> torch.Tensor:
    """Plain version of ``pack_rows``: one [n, width] gather, masked."""
    n = starts.shape[0]
    out = torch.zeros((rows, width), dtype=torch.uint8, device=payload.device)
    if n == 0 or payload.numel() == 0:
        return out
    col = torch.arange(width, device=payload.device)
    keep = col[None, :] < (lens - skip).clamp(0, width)[:, None]
    src = (starts[:, None] + skip + col[None, :]).clamp(0, payload.numel() - 1)
    out[:n] = payload[src].masked_fill_(~keep, 0)
    return out
