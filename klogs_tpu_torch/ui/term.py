"""Terminal colors and severity printers.

Reference parity: klogs does all terminal output through pterm's
severity printers (Info/Warning/Error/Fatal prefixes, e.g.
cmd/root.go:78,98,102,147,267,274,284,316,327,393) and color helpers
(pterm.Green/Red/Gray/Blue). This module is the stdlib-only analog:
ANSI SGR with a global on/off switch (auto-detected from tty / NO_COLOR)
so tests can force deterministic output.
"""

import os
import sys

_FORCED: bool | None = None


def _auto() -> bool:
    if "NO_COLOR" in os.environ:
        return False
    try:
        return sys.stdout.isatty()
    except Exception:
        return False


def colors_enabled() -> bool:
    return _FORCED if _FORCED is not None else _auto()


def set_colors(enabled: bool | None) -> None:
    """Force colors on/off, or None to restore auto-detection."""
    global _FORCED
    _FORCED = enabled


_UI_STREAM = None


def set_ui_stream(stream) -> None:
    """Route all UI output (severity printers, widgets) to ``stream``;
    None restores sys.stdout."""
    global _UI_STREAM
    _UI_STREAM = stream


def ui_stream():
    return _UI_STREAM if _UI_STREAM is not None else sys.stdout


def _sgr(code: str, text: str) -> str:
    if not colors_enabled():
        return text
    return f"\x1b[{code}m{text}\x1b[0m"


def green(text: str) -> str:
    return _sgr("32", text)


def red(text: str) -> str:
    return _sgr("31", text)


def gray(text: str) -> str:
    return _sgr("90", text)


def blue(text: str) -> str:
    return _sgr("34", text)


class Printer:
    """A pterm-style severity printer: `` PREFIX  message``."""

    def __init__(self, prefix: str, code: str, stream=None):
        self.prefix = prefix
        self.code = code
        self.stream = stream

    def __call__(self, fmt: str, *args) -> None:
        out = self.stream or ui_stream()
        msg = (fmt % args) if args else fmt
        badge = _sgr(self.code, f" {self.prefix} ")
        print(f"{badge} {msg}", file=out)


info = Printer("INFO", "30;46")
error = Printer("ERROR", "30;41")


class FatalError(SystemExit):
    """Raised by fatal(); carries exit status 1 like pterm.Fatal."""


def fatal(fmt: str, *args) -> None:
    Printer("FATAL", "30;41")(fmt, *args)
    raise FatalError(1)
