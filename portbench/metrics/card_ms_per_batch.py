"""device: the card's own time a batch: the mean ``card.batch`` span
started in the window (its stream from the batch's first op, the staging
copy, to its last, the verdicts' copy out)."""


def read(tr):
    ms = [s["duration_s"] * 1e3 for s in tr.spans_named("card.batch")]
    return sum(ms) / len(ms) if ms else None
