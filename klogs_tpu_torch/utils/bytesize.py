"""Human-readable byte sizes.

Reference parity: ``convertBytes`` (cmd/root.go:423-434) — zero renders
red "0 B"; below 1 KiB exact bytes; otherwise integer *floor* division
to KB / MB (1.5 KB renders "1 KB", cmd/root_test.go:20-23). The
reference never renders GB; MB is the terminal unit.
"""

from klogs_tpu_torch.ui.term import red


def convert_bytes(n: int, *, color: bool = True) -> str:
    if n == 0:
        return red("0 B") if color else "0 B"
    if n < 1024:
        return f"{n} B"
    if n < 1024 * 1024:
        return f"{n // 1024} KB"
    return f"{n // 1024 // 1024} MB"
