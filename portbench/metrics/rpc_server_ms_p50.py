"""service: the median MatchFramed RPC's time inside filterd (its
``rpc.server`` span: decode, the coalescer, the engine, the verdicts)."""

import statistics


def read(tr):
    ms = [s["duration_s"] * 1e3 for s in tr.spans_named("rpc.server")
          if s["attrs"].get("method") == "MatchFramed"]
    return statistics.median(ms) if ms else None
