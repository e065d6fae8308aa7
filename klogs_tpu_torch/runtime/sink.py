"""Sinks: where stream bytes land.

Counterpart of ``klogs_tpu/runtime/sink.py``. FileSink is the
reference's buffered whole-stream copy: chunks go to a buffered file
untouched. A write or flush failure marks the sink failed with one
``SinkError`` naming the path and releases the file at once; every later
write raises the same error.
"""

import abc


class SinkError(Exception):
    """A sink write/flush failed terminally; the message is the single
    operator-facing line (path and cause)."""


class Sink(abc.ABC):
    @abc.abstractmethod
    async def write(self, chunk: bytes) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None:
        """Flush and release; idempotent."""

    @property
    @abc.abstractmethod
    def bytes_written(self) -> int: ...


class FileSink(Sink):
    """Buffered whole-stream copy to one log file (truncated on open)."""

    def __init__(self, path: str, buffer_size: int = 1 << 16):
        self._path = path
        self._f = open(path, "wb", buffering=buffer_size)
        self._bytes = 0
        self._closed = False
        self._failed: "str | None" = None

    async def write(self, chunk: bytes) -> None:
        if self._failed is not None:
            raise SinkError(self._failed)
        try:
            self._f.write(chunk)
        except OSError as e:
            self._failed = f"write to {self._path} failed: {e}"
            self._closed = True
            try:
                self._f.close()
            except OSError:
                pass  # the same dead disk; the fd is released regardless
            raise SinkError(self._failed) from e
        self._bytes += len(chunk)

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._f.flush()
        except OSError as e:
            self._failed = f"flush of {self._path} failed: {e}"
            raise SinkError(self._failed) from e
        finally:
            try:
                self._f.close()
            except OSError:
                pass  # flush already reported; the fd is released

    @property
    def bytes_written(self) -> int:
        return self._bytes
