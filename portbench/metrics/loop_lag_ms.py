"""service: how late filterd's event-loop timer fired in the window, on
average (``klogs_loop_lag_seconds``, re-armed every 50 ms: its sum over
its count)."""


def read(tr):
    total, count = tr.counters.get("klogs_loop_lag_seconds", (0.0, 0.0))
    return total / count * 1e3 if count else None
