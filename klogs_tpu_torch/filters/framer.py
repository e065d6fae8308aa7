"""Incremental line framing.

Counterpart of ``klogs_tpu/filters/framer.py``. Log chunks arrive with
line boundaries anywhere inside them. ``FramedBatcher`` appends chunks
to one contiguous buffer and a numpy newline sweep records each complete
line's end, so the pending batch goes to the framed filter path as
``(payload, offsets, n)`` with no per-line Python object;
``join_kept_framed`` gathers the kept lines back out of the same
buffer.
"""

import numpy as np


class FramedBatcher:
    """Chunk stream -> framed pending batch. Lines keep their trailing
    newline (the engines strip it at match time), so the kept-line join
    is a span gather of the same buffer."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._ends: list[np.ndarray] = []
        self.pending_lines = 0

    def feed(self, chunk: bytes) -> int:
        """The number of complete pending lines after this chunk."""
        base = len(self._buf)
        self._buf += chunk
        ends = np.flatnonzero(np.frombuffer(chunk, dtype=np.uint8) == 0x0A)
        if len(ends):
            self._ends.append((ends + (base + 1)).astype(np.int64))
            self.pending_lines += len(ends)
        return self.pending_lines

    def take(self, final: bool = False):
        """(payload: bytes, offsets: int32[n+1], n) of every complete
        pending line; resets, carrying the unterminated tail forward.
        ``final`` emits the tail as a last unterminated line."""
        n = self.pending_lines
        ends = (np.concatenate(self._ends) if self._ends
                else np.zeros(0, dtype=np.int64))
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
    """The bytes of the framed lines whose verdict is True, in order."""
    mask = np.asarray(mask, dtype=bool)
    if mask.all():
        return bytes(payload[int(offsets[0]):int(offsets[-1])])
    lens = np.diff(np.asarray(offsets, dtype=np.int64))
    arr = np.frombuffer(payload, dtype=np.uint8)[int(offsets[0]):int(offsets[-1])]
    return arr[np.repeat(mask, lens)].tobytes()
