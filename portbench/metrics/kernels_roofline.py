"""ops: the window's kernels against the byte roofline: the least time
(``_roofline.least_time_s`` of the lines dispatched in the window) over
their summed kernel time, in percent."""

from portbench.metrics._roofline import least_time_s


def read(tr):
    kernels = tr.kernels()
    batches = tr.batches()
    if not kernels or not batches or not tr.peaks:
        return None
    busy = sum(b - a for _, _, a, b in kernels)
    least = least_time_s(
        sum(int(s["attrs"].get("bytes", 0)) for s in batches),
        sum(int(s["attrs"].get("rows", 0)) for s in batches),
        len(batches), tr.pattern_bytes, tr.peaks["hbm_bytes_s"])
    return least / busy * 100.0
