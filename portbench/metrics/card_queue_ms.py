"""device: a batch's wait on the card's stream: the mean ``queued_s`` of
the ``card.batch`` spans started in the window (the card reaching the
batch's first op, less the host time that op was enqueued; both on the
host's clock, by CUDA events)."""


def read(tr):
    queued = [s["attrs"]["queued_s"] for s in tr.spans_named("card.batch")
              if "queued_s" in s["attrs"]]
    return sum(queued) / len(queued) * 1e3 if queued else None
