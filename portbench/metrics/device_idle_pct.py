"""device: the share of the traced window in which no kernel, copy or
fill runs on the card (the union of ``torch.profiler``'s device
intervals)."""


def read(tr):
    if not tr.has_device_trace or tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0
