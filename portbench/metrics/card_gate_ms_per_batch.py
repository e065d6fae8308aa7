"""ops: the gate's card time a batch: the ``card.gate`` spans (the sweep
or the pair-CNF, with K3's pair builder) summed over the ``card.batch``
spans started in the window that have one, over those batches."""


def read(tr):
    batches = {s["span_id"] for s in tr.spans_named("card.batch")}
    per_batch: "dict[str, float]" = {}
    for s in tr.spans:
        if s["name"] == "card.gate" and s.get("parent_id") in batches:
            per_batch[s["parent_id"]] = (per_batch.get(s["parent_id"], 0.0)
                                         + s["duration_s"])
    if not per_batch:
        return None
    return sum(per_batch.values()) / len(per_batch) * 1e3
