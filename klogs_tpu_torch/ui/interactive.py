"""Interactive terminal selection (counterpart of
``klogs_tpu/ui/interactive.py``).

Reference parity: pterm InteractiveSelect for namespaces
(cmd/root.go:117-122) and InteractiveMultiselect for pods — filter
disabled, Enter=confirm, Space=select, MaxHeight 15 (cmd/root.go:167-182).

Implementation: raw-mode arrow-key navigation via termios. Both entry
points accept an injectable ``keys`` iterator so tests can drive them
without a tty; without a tty and without injected keys they raise.
"""

import sys
from typing import Iterable, Iterator

from klogs_tpu_torch.ui import term

MAX_HEIGHT = 15

UP, DOWN, ENTER, SPACE = "up", "down", "enter", "space"


def _read_keys_tty() -> Iterator[str]:
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            ch = sys.stdin.read(1)
            if ch == "\x1b":
                seq = sys.stdin.read(2)
                if seq == "[A":
                    yield UP
                elif seq == "[B":
                    yield DOWN
            elif ch in ("\r", "\n"):
                yield ENTER
            elif ch == " ":
                yield SPACE
            elif ch in ("\x03", "q"):
                yield "quit"
            else:
                yield ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


class NotInteractive(RuntimeError):
    pass


def _keys_or_tty(keys: Iterable[str] | None) -> Iterator[str]:
    if keys is not None:
        return iter(keys)
    try:
        if sys.stdin.isatty():
            return _read_keys_tty()
    except Exception:
        pass
    raise NotInteractive(
        "interactive selection requires a terminal "
        "(select explicitly with flags instead: -n <namespace>, -a for all "
        "pods, or -l <label>)"
    )


def _render(options: list[str], cursor: int, selected: set[int] | None,
            top: int, out) -> int:
    """Render a window of options; returns number of lines printed."""
    height = min(len(options), MAX_HEIGHT)
    lines = 0
    for i in range(top, top + height):
        marker = ">" if i == cursor else " "
        if selected is not None:
            box = "[x]" if i in selected else "[ ]"
            text = f"{marker} {box} {options[i]}"
        else:
            text = f"{marker} {options[i]}"
        if i == cursor:
            text = term.green(text)
        print(text, file=out)
        lines += 1
    return lines


def _clear(n: int, out) -> None:
    try:
        is_tty = out.isatty()
    except Exception:
        is_tty = False
    if is_tty and n:
        print(f"\x1b[{n}A\x1b[0J", end="", file=out)


def interactive_select(
    options: list[str], default_text: str,
    keys: Iterable[str] | None = None, out=None,
) -> str:
    """Single choice (namespace picker, cmd/root.go:117-122)."""
    out = out or term.ui_stream()
    key_iter = _keys_or_tty(keys)
    cursor, top = 0, 0
    print(f"{default_text}:", file=out)
    printed = _render(options, cursor, None, top, out)
    for key in key_iter:
        _clear(printed, out)
        if key == UP:
            cursor = max(0, cursor - 1)
        elif key == DOWN:
            cursor = min(len(options) - 1, cursor + 1)
        elif key == ENTER:
            return options[cursor]
        top = min(max(top, cursor - MAX_HEIGHT + 1), cursor)
        printed = _render(options, cursor, None, top, out)
    # keys exhausted without Enter (test injection): current cursor wins
    return options[cursor]


def interactive_multiselect(
    options: list[str], default_text: str,
    keys: Iterable[str] | None = None, out=None,
) -> list[str]:
    """Multi choice (pod picker, cmd/root.go:167-182): Space toggles,
    Enter confirms, no filter, window of MAX_HEIGHT."""
    out = out or term.ui_stream()
    key_iter = _keys_or_tty(keys)
    cursor, top = 0, 0
    selected: set[int] = set()
    print(f"{default_text} (space=select, enter=confirm):", file=out)
    printed = _render(options, cursor, selected, top, out)
    for key in key_iter:
        _clear(printed, out)
        if key == UP:
            cursor = max(0, cursor - 1)
        elif key == DOWN:
            cursor = min(len(options) - 1, cursor + 1)
        elif key == SPACE:
            selected.symmetric_difference_update({cursor})
        elif key == ENTER:
            break
        top = min(max(top, cursor - MAX_HEIGHT + 1), cursor)
        printed = _render(options, cursor, selected, top, out)
    return [options[i] for i in sorted(selected)]
