"""filters.async_service: lines a coalesced group carried to the engine
in the window (``klogs_coalescer_group_lines``, its sum over its count)."""


def read(tr):
    total, count = tr.counters.get("klogs_coalescer_group_lines", (0.0, 0.0))
    return total / count if count else None
