"""service: an RPC's mean wait in filterd before its handler runs, in the
window (``klogs_rpc_receive_seconds``: from its arrival, before the
request message is read, to the handler's entry; the request's transfer
and the event loop's delay)."""


def read(tr):
    total, count = tr.counters.get("klogs_rpc_receive_seconds", (0.0, 0.0))
    return total / count * 1e3 if count else None
