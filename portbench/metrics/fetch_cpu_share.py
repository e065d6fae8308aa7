"""filters.async_service: the CPU time the coalescer's fetch threads used
in the engine's fetch over the time they spent in it, in the window
(``klogs_fetch_cpu_seconds_total`` over ``klogs_fetch_wait_seconds_total``):
near 1 where they spin on the card's event, near 0 where they sleep."""


def read(tr):
    wait = tr.counters.get("klogs_fetch_wait_seconds_total", (0.0, 0.0))[0]
    cpu = tr.counters.get("klogs_fetch_cpu_seconds_total", (0.0, 0.0))[0]
    return cpu / wait if wait > 0 else None
