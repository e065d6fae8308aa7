"""Incremental line framing.

Counterpart of ``klogs_tpu/filters/framer.py``. Log chunks arrive with
line boundaries anywhere inside them. ``FramedBatcher`` appends chunks
to one contiguous buffer and the C newline sweep (``find_newlines`` of
the port's ``native/_hostops.c``) records each complete line's end, so
the pending batch goes to the framed filter path as ``(payload,
offsets, n)`` with no per-line Python object; ``join_kept_framed``
gathers the kept lines back out of the same buffer in C.
``find_newlines_plain`` and ``join_kept_framed_plain`` are the numpy
versions of the two C functions, with their checks; only the tests call
them. ``LineFramer`` is the list form the console sinks render from.
"""

import numpy as np

from klogs_tpu_torch.filters.base import _INT32_MAX
from klogs_tpu_torch.native import hostops


class LineFramer:
    def __init__(self) -> None:
        self._rest = b""

    def feed(self, chunk: bytes) -> list[bytes]:
        """Returns the complete lines made available by this chunk, each
        including its trailing newline."""
        data = self._rest + chunk if self._rest else chunk
        if b"\n" not in data:
            self._rest = data
            return []
        body, _, rest = data.rpartition(b"\n")
        self._rest = rest
        return [ln + b"\n" for ln in body.split(b"\n")]

    def flush(self) -> bytes | None:
        """The final unterminated line, if any (stream ended mid-line)."""
        rest, self._rest = self._rest, b""
        return rest if rest else None


class FramedBatcher:
    """Chunk stream -> framed pending batch. Lines keep their trailing
    newline (the engines strip it at match time), so the kept-line join
    is a span gather of the same buffer. ``find_newlines`` is the
    sweep's function, the C one unless a test hands in the plain one."""

    def __init__(self, find_newlines=None) -> None:
        self._find_newlines = (find_newlines if find_newlines is not None
                               else hostops().find_newlines)
        self._buf = bytearray()
        self._ends: list[bytes] = []  # int32 end offsets, raw bytes
        self.pending_lines = 0

    def feed(self, chunk: bytes) -> int:
        """The number of complete pending lines after this chunk."""
        base = len(self._buf)
        self._buf += chunk
        ends = self._find_newlines(chunk, base)
        if ends:
            self._ends.append(ends)
            self.pending_lines += len(ends) // 4
        return self.pending_lines

    def take(self, final: bool = False):
        """(payload: bytes, offsets: int32[n+1], n) of every complete
        pending line; resets, carrying the unterminated tail forward.
        ``final`` emits the tail as a last unterminated line."""
        n = self.pending_lines
        ends = (np.frombuffer(b"".join(self._ends), dtype=np.int32)
                if self._ends else np.zeros(0, dtype=np.int32))
        cut = int(ends[-1]) if n else 0
        tail_len = len(self._buf) - cut
        if final and tail_len:
            payload = bytes(self._buf)
            offsets = np.empty(n + 2, dtype=np.int32)
            offsets[n + 1] = len(payload)
            self._buf = bytearray()
            n += 1
        else:
            payload = bytes(self._buf[:cut])
            offsets = np.empty(n + 1, dtype=np.int32)
            self._buf = bytearray(self._buf[cut:]) if tail_len else bytearray()
        offsets[0] = 0
        offsets[1:len(ends) + 1] = ends
        self._ends = []
        self.pending_lines = 0
        return payload, offsets, n


def join_kept_framed(payload: bytes, offsets, mask) -> bytes:
    """The bytes of the framed lines whose verdict is True, in order
    (the C function: adjacent kept lines are one memcpy). A mask shorter
    than the lines raises ValueError."""
    return hostops().join_kept_framed(
        payload, np.ascontiguousarray(offsets, dtype=np.int32),
        len(offsets) - 1, np.ascontiguousarray(mask, dtype=bool).view(np.uint8))


def find_newlines_plain(data, base: int) -> bytes:
    """The numpy version of ``find_newlines``: int32 positions after
    each newline of ``data``, plus ``base``, as bytes."""
    if base < 0 or base + len(data) > _INT32_MAX:
        raise OverflowError("framed buffer exceeds int32 offsets")
    ends = np.flatnonzero(np.frombuffer(data, dtype=np.uint8) == 0x0A)
    return (ends + (base + 1)).astype(np.int32).tobytes()


def join_kept_framed_plain(payload: bytes, offsets, mask) -> bytes:
    """The numpy version of ``join_kept_framed``, with its checks."""
    offsets = np.asarray(offsets, dtype=np.int64)
    mask = np.asarray(mask, dtype=bool)
    n = len(offsets) - 1
    if n < 0 or len(mask) < n:
        raise ValueError("join_kept_framed: bad sizes")
    lens = np.diff(offsets)
    if n and (offsets[:-1].min() < 0 or lens.min() < 0
              or offsets[1:].max() > len(payload)):
        raise ValueError("join_kept_framed: offsets out of range")
    if n == 0:
        return b""
    # Line i spans [offsets[i], offsets[i + 1]): one byte mask over the
    # frame's span.
    span = np.frombuffer(payload, dtype=np.uint8)[offsets[0]:offsets[-1]]
    return span[np.repeat(mask[:n], lens)].tobytes()
