"""The ragged pack: a framed payload cut into rows on the device, and
classified there.

The JAX engine feeds its kernels through a host packer
(``klogs_tpu/native/_hostops.c`` ``pack_classify_framed``): every width
bucket's lines are stripped of their trailing newlines, cut out of the
contiguous payload and classified into int8 class ids on the host, and
the class ids cross to the device. Here the payload and its per-line
starts and raw lengths cross once per batch, and one kernel,
``pack_classify_rows``, does the packer's work for each bucket, and for
each chunk of the long lines, where the payload already lies:

    len[r] = lens[r] less its trailing run of b"\\n"      (0 for r >= n)
    cls[r] = classify_chunk(prog, row bytes from skip on, len[r] - skip,
                            first, final)

as int16 class ids ``[rows, width + first + 2*final]`` (the layout the
NFA kernels read), with the stripped lengths and, when a gate reads
bytes, the zero-padded byte rows. ``skip = 0`` with ``first`` and
``final`` serves the width buckets, ``skip = k * chunk_bytes`` chunk k
of the long lines.

``pack_rows`` cuts byte rows only (no strip, no classes):

    row r = payload[starts[r] + skip : starts[r] + skip + clamp(lens[r] - skip, 0, width)]

zero-padded to ``width``, rows at or past ``len(starts)`` all zero. The
indexed engine's device sweep uses it.

A tensor on the CPU runs the plain versions (``pack_classify_rows_plain``,
``pack_rows_plain``); a CUDA tensor launches ``pack_classify_kernel``
(``pack_classify_flat`` for rows past 1024 bytes) or ``pack_rows_kernel``
from ``ops/csrc/pack_kernels.cu``, or raises.
Launches count in ``nfa_kernels.LAUNCHES`` under ``PACK_CLS`` and
``PACK``.
"""

import ctypes
import threading

import torch

from klogs_tpu_torch.ops import nfa_kernels
from klogs_tpu_torch.ops.nfa import TorchProgram, classify_chunk
from klogs_tpu_torch.ops.nfa_kernels import PACK, PACK_CLS

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
            ll = ctypes.c_longlong
            lib.klogs_pack_classify_rows.argtypes = [
                p, p, p, i, i, i, ll, i, i, p, i, i, i, p, p, p, i, p, i]
            lib.klogs_pack_classify_rows.restype = i
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
        _raise_launch(PACK, err)
    return out


def _raise_launch(name: str, err: int) -> None:
    msg = _library().klogs_pack_error_string(err).decode()
    raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def pack_classify_rows(payload: torch.Tensor, starts: torch.Tensor,
                       lens: torch.Tensor, width: int, rows: int,
                       prog: TorchProgram, skip: int = 0, first: bool = True,
                       final: bool = True, want_bytes: bool = False):
    """[P] uint8 payload + [n] int64 starts and raw lengths -> (class
    ids [rows, width + first + 2*final] int16, stripped lengths [rows]
    int64, and the byte rows [rows, width] uint8 of ``pack_rows`` with
    the stripped lengths when ``want_bytes``, else None), classified
    through ``prog``'s ``byte_class`` and sentinels. One launch; nothing
    waits on the host."""
    _check_args(payload, starts, lens, width, rows, skip)
    if payload.device.type == "cpu":
        return pack_classify_rows_plain(payload, starts, lens, width, rows,
                                        prog, skip, first, final, want_bytes)
    return _launch_classify(payload, starts, lens, width, rows, prog, skip,
                            first, final, want_bytes)


def _launch_classify(payload, starts, lens, width, rows, prog, skip=0,
                     first=True, final=True, want_bytes=False, flat=False):
    """``pack_classify_rows`` on a card; ``flat`` takes the kernel's flat
    schedule whatever the shape (``chip_smoke.py`` times the two)."""
    if payload.device.type != "cuda":
        raise ValueError(f"unsupported device {payload.device}")
    dev = payload.device
    table = prog.byte_class
    if table.device != dev or table.dtype != torch.int32 or \
            table.shape != (256,):
        raise ValueError(f"byte_class must be [256] int32 on {dev}, got "
                         f"{table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    payload, table = payload.contiguous(), table.contiguous()
    starts, lens = starts.contiguous(), lens.contiguous()
    T = width + int(first) + 2 * int(final)
    # Each output allocated once (the allocator's blocks are 512-byte
    # aligned, as the kernel's 16-byte stores need); slicing one buffer
    # costs the host more than three allocations.
    cls = torch.empty((rows, T), dtype=torch.int16, device=dev)
    out_lens = torch.empty(rows, dtype=torch.int64, device=dev)
    batch = (torch.empty((rows, width), dtype=torch.uint8, device=dev)
             if want_bytes else None)
    err = _library().klogs_pack_classify_rows(
        payload.data_ptr(), starts.data_ptr(), lens.data_ptr(),
        starts.shape[0], width, rows, skip, int(first), int(final),
        table.data_ptr(), prog.begin_class, prog.end_class, prog.pad_class,
        cls.data_ptr(), out_lens.data_ptr(),
        batch.data_ptr() if want_bytes else None, int(flat),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    nfa_kernels._count(PACK_CLS)
    if err != 0:
        _raise_launch(PACK_CLS, err)
    return cls, out_lens, batch


def _stripped_lengths(payload: torch.Tensor, starts: torch.Tensor,
                     lens: torch.Tensor) -> torch.Tensor:
    """Each line's length less its trailing run of b"\\n" (the
    ``rstrip(b"\\n")`` rule), one pass a byte of the longest run."""
    if payload.numel() == 0:
        return lens.clone()
    ends = starts + lens
    while True:
        last = payload[(ends - 1).clamp(0, payload.numel() - 1)]
        m = (ends > starts) & (last == 0x0A)
        if not bool(m.any()):
            return ends - starts
        ends = ends - m.to(torch.int64)


def pack_classify_rows_plain(payload: torch.Tensor, starts: torch.Tensor,
                             lens: torch.Tensor, width: int, rows: int,
                             prog: TorchProgram, skip: int = 0,
                             first: bool = True, final: bool = True,
                             want_bytes: bool = False):
    """Plain version of ``pack_classify_rows``: the strip, ``pack_rows_plain``
    and ``classify_chunk``."""
    n = starts.shape[0]
    stripped = torch.zeros(rows, dtype=torch.int64, device=payload.device)
    stripped[:n] = _stripped_lengths(payload, starts, lens)
    batch = pack_rows_plain(payload, starts, stripped[:n], width, rows, skip)
    cls = classify_chunk(prog, batch, stripped - skip, first, final)
    return cls, stripped, batch if want_bytes else None


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
