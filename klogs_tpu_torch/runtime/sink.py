"""Sinks: where stream bytes land.

Counterpart of ``klogs_tpu/runtime/sink.py``. FileSink is the
reference's buffered whole-stream copy: chunks go to a buffered file
untouched. A write or flush failure marks the sink failed with one
``SinkError`` naming the path and releases the file at once; every later
write raises the same error. ``sink.write`` is a fault point
(``resilience/faults.py``): a fired fault fails the sink as a full disk
would.
"""

import abc

from klogs_tpu_torch.resilience.faults import FAULTS, InjectedFault


class SinkError(Exception):
    """A sink write/flush failed terminally; the message is the single
    operator-facing line (path and cause)."""


class Sink(abc.ABC):
    @abc.abstractmethod
    async def write(self, chunk: bytes) -> None: ...

    @abc.abstractmethod
    async def close(self) -> None:
        """Flush and release; idempotent."""

    async def flush(self) -> None:
        """Push buffered bytes through (for live tailing); default no-op."""

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

    def _fail(self, what: str, e: BaseException) -> SinkError:
        """Mark the sink failed with one clear error, release the fd, and
        return the SinkError to raise."""
        self._failed = f"{what} {self._path} failed: {e}"
        self._closed = True
        try:
            self._f.close()
        except OSError:
            pass  # the same dead disk; the fd is released regardless
        return SinkError(self._failed)

    async def write(self, chunk: bytes) -> None:
        if self._failed is not None:
            raise SinkError(self._failed)
        try:
            if FAULTS.active:
                await FAULTS.fire("sink.write")
            self._f.write(chunk)
        except (OSError, InjectedFault) as e:
            raise self._fail("write to", e) from e
        self._bytes += len(chunk)

    async def flush(self) -> None:
        if self._closed or self._failed is not None:
            return
        try:
            self._f.flush()
        except OSError as e:
            raise self._fail("flush of", e) from e

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
