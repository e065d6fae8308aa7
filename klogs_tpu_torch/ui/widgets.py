"""Terminal widgets: splash banner, tree, boxed table.

Reference parity:
- splash: pterm BigText "KLogs", K blue + "Logs" white (cmd/root.go:56-66)
- tree: per-pod container tree (cmd/root.go:231-273)
- table: boxed, header row, Pod/Container/Size (cmd/root.go:279-309)
- spinner: the follow-mode "press q" line (cmd/root.go:399-421)
"""

import asyncio
import itertools

from klogs_tpu_torch.ui import term

# 5-row banner glyphs (figlet-style) for the letters of "KLogs".
_BIG = {
    "K": ["#   #", "#  # ", "###  ", "#  # ", "#   #"],
    "L": ["#    ", "#    ", "#    ", "#    ", "#####"],
    "o": ["     ", " ### ", "#   #", "#   #", " ### "],
    "g": [" ####", "#   #", " ####", "    #", " ### "],
    "s": [" ####", "#    ", " ### ", "    #", "#### "],
}


def splash_screen(out=None) -> None:
    out = out or term.ui_stream()
    rows = ["", "", "", "", ""]
    for i, ch in enumerate("KLogs"):
        glyph = _BIG[ch]
        for r in range(5):
            piece = glyph[r] + "  "
            rows[r] += term.blue(piece) if i == 0 else piece
    print("\n".join(rows) + "\n", file=out)


class Spinner:
    """Async spinner; removed from the line when stopped. Without a tty
    it prints its text once."""

    FRAMES = [".  ", ".. ", ".|.", " ..", "  ."]

    def __init__(self, text: str, out=None):
        self.text = text
        self.out = out or term.ui_stream()
        self._task: asyncio.Task | None = None

    async def _spin(self) -> None:
        try:
            is_tty = self.out.isatty()
        except Exception:
            is_tty = False
        if not is_tty:
            print(self.text, file=self.out)
            return
        for frame in itertools.cycle(self.FRAMES):
            print(f"\r{frame} {self.text}", end="", flush=True, file=self.out)
            await asyncio.sleep(0.15)

    async def __aenter__(self) -> "Spinner":
        self._task = asyncio.create_task(self._spin())
        return self

    async def __aexit__(self, *exc) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        try:
            if self.out.isatty():
                print("\r\x1b[2K", end="", flush=True, file=self.out)
        except Exception:
            pass


def render_tree(root: str, children: list[str], out=None) -> None:
    """One pod tree: root label + branch per container."""
    out = out or term.ui_stream()
    print(root, file=out)
    for i, child in enumerate(children):
        branch = "└─" if i == len(children) - 1 else "├─"
        print(f"{branch}{child}", file=out)


def render_table(data: list[list[str]], out=None) -> None:
    """Boxed table with a header row (pterm WithHasHeader().WithBoxed())."""
    out = out or term.ui_stream()
    if not data:
        return
    ncols = max(len(r) for r in data)
    widths = [0] * ncols
    for row in data:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(_strip_ansi(cell)))

    def fmt_row(row: list[str]) -> str:
        cells = []
        for i in range(ncols):
            cell = row[i] if i < len(row) else ""
            pad = widths[i] - len(_strip_ansi(cell))
            cells.append(cell + " " * pad)
        return "│ " + " │ ".join(cells) + " │"

    def edge(left: str, mid: str, right: str) -> str:
        return left + mid.join("─" * (w + 2) for w in widths) + right

    print(edge("┌", "┬", "┐"), file=out)
    print(fmt_row(data[0]), file=out)
    print(edge("├", "┼", "┤"), file=out)
    for row in data[1:]:
        print(fmt_row(row), file=out)
    print(edge("└", "┴", "┘"), file=out)


def _strip_ansi(s: str) -> str:
    import re

    return re.sub(r"\x1b\[[0-9;]*m", "", s)
