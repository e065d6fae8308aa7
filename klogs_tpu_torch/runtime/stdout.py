"""Console sinks: stern-style multiplexed stdout output (``-o stdout``,
``-o both``, ``--format json``).

Counterpart of ``klogs_tpu/runtime/stdout.py``. Chunks are framed into
lines first, so concurrent streams interleave at line granularity: one
container's line is never split by another's output (the fan-out runs
on one event loop and each batch of lines is one ``write`` on the
shared buffer). The prefix color is stable per pod name across runs
(CRC-based, not the per-process salted ``hash()``).
"""

import json
import re
import sys
import zlib

from klogs_tpu_torch.filters.framer import LineFramer
from klogs_tpu_torch.runtime.sink import Sink
from klogs_tpu_torch.ui import term

# SGR codes for pod prefixes: six distinguishable base colors, then
# their bright variants. Red is reserved for the severity printers.
_POD_COLOR_CODES = ("36", "32", "33", "35", "34",
                    "96", "92", "93", "95", "94")


def pod_color_code(pod: str) -> str:
    """Stable pod -> SGR color code mapping."""
    return _POD_COLOR_CODES[zlib.crc32(pod.encode()) % len(_POD_COLOR_CODES)]


_HL_ON = b"\x1b[1;31m"
_HL_OFF = b"\x1b[0m"


def compile_highlights(patterns, ignore_case: bool = False) -> list:
    """--match patterns as bytes regexes for console highlighting (only
    used when colors are on); a pattern ``re`` cannot take is skipped
    rather than breaking the stream."""
    out = []
    for p in patterns or ():
        try:
            out.append(re.compile(p.encode(),
                                  re.IGNORECASE if ignore_case else 0))
        except (re.error, UnicodeEncodeError):
            pass
    return out


class _ConsoleSink(Sink):
    """Shared console lifecycle: incremental framing, write-through
    flushing (the console is a live surface: stdout's own buffering
    would hold lines for seconds on quiet streams), and a close() that
    emits any unterminated final fragment. Subclasses provide
    ``_render(lines) -> bytes``."""

    def __init__(self, out=None):
        self._framer = LineFramer()
        self._out = out if out is not None else sys.stdout.buffer
        self._bytes = 0
        self._closed = False

    async def write(self, chunk: bytes) -> None:
        self._emit(self._framer.feed(chunk))

    def _emit(self, lines: list) -> None:
        if not lines:
            return
        buf = self._render(lines)
        self._out.write(buf)
        self._out.flush()
        self._bytes += len(buf)

    async def flush(self) -> None:
        if not self._closed:
            self._out.flush()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        rest = self._framer.flush()
        if rest is not None:
            # Stream ended mid-line: terminate the fragment, or it would
            # fuse with the next stream's prefix.
            self._emit([rest + b"\n"])
        self._out.flush()

    @property
    def bytes_written(self) -> int:
        return self._bytes


class StdoutSink(_ConsoleSink):
    """Line-prefixed console sink for one (pod, container) stream.
    ``highlight`` (compile_highlights output) wraps each --match hit in
    bold red, only when colors are on."""

    def __init__(self, pod: str, container: str, out=None,
                 highlight: list | None = None):
        super().__init__(out)
        prefix = f"{pod} {container}"
        if term.colors_enabled():
            prefix = f"\x1b[{pod_color_code(pod)}m{prefix}\x1b[0m"
            self._highlight = highlight or []
        else:
            self._highlight = []
        self._prefix = (prefix + " ").encode()

    def _decorate(self, ln: bytes) -> bytes:
        # Spans are found on the body (newline excluded) and the codes
        # inserted in one pass: sequential substitution would let later
        # patterns match inside earlier escape codes.
        body = ln[:-1] if ln.endswith(b"\n") else ln
        spans = []
        for rx in self._highlight:
            for m in rx.finditer(body):
                if m.group(0):  # a zero-width match adds nothing
                    spans.append((m.start(), m.end()))
        if not spans:
            return ln
        spans.sort()
        merged = [list(spans[0])]
        for s, e in spans[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        out = bytearray()
        prev = 0
        for s, e in merged:
            out += body[prev:s] + _HL_ON + body[s:e] + _HL_OFF
            prev = e
        out += body[prev:]
        return bytes(out) + ln[len(body):]

    def _render(self, lines: list) -> bytes:
        if self._highlight:
            lines = [self._decorate(ln) for ln in lines]
        return b"".join(self._prefix + ln for ln in lines)


class JsonStdoutSink(_ConsoleSink):
    """``--format json``: one ``{"pod", "container", "line"}`` object per
    log line; the line is decoded as UTF-8 with replacement and carries
    no trailing newline."""

    def __init__(self, pod: str, container: str, out=None):
        super().__init__(out)
        self._pod = pod
        self._container = container

    def _render(self, lines: list) -> bytes:
        return b"".join(
            json.dumps({
                "pod": self._pod,
                "container": self._container,
                "line": ln.rstrip(b"\n").decode("utf-8", "replace"),
            }, ensure_ascii=False).encode() + b"\n"
            for ln in lines
        )


class TeeSink(Sink):
    """One stream's bytes to several sinks (``-o both``).
    ``bytes_written`` is the FIRST sink's (the file's, with ``both``)."""

    def __init__(self, *sinks: Sink):
        if not sinks:
            raise ValueError("TeeSink needs at least one sink")
        self._sinks = sinks
        self._closed = False

    async def write(self, chunk: bytes) -> None:
        for s in self._sinks:
            await s.write(chunk)

    async def flush(self) -> None:
        for s in self._sinks:
            await s.flush()

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for s in self._sinks:
            await s.close()

    @property
    def bytes_written(self) -> int:
        return self._sinks[0].bytes_written
