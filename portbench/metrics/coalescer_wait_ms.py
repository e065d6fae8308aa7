"""filters.async_service: a caller's wait from its enqueue to its
group's dispatch in the window (``klogs_coalescer_queue_wait_seconds``:
the coalescing delay and the wait for an in-flight slot)."""


def read(tr):
    total, count = tr.counters.get("klogs_coalescer_queue_wait_seconds",
                                   (0.0, 0.0))
    return total / count * 1e3 if count else None
