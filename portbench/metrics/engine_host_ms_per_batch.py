"""filters.gpu: the engine's host time a device batch: its outer
``device.frame`` span (the layout, the staging copy) and its
``device.kernel`` spans (each sub-batch's enqueue), over the batches
dispatched in the window."""


def read(tr):
    batches = tr.batches()
    if not batches:
        return None
    host = sum(s["duration_s"] for s in batches)
    host += sum(s["duration_s"] for s in tr.spans_named("device.kernel"))
    return host / len(batches) * 1e3
