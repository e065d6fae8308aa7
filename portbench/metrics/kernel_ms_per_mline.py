"""ops: the card's summed kernel time in the window (``torch.profiler``,
copies and fills left out) a million lines dispatched in it."""


def read(tr):
    kernels = tr.kernels()
    lines = sum(int(s["attrs"].get("rows", 0)) for s in tr.batches())
    if not kernels or not lines:
        return None
    return sum(b - a for _, _, a, b in kernels) * 1e3 / (lines / 1e6)
