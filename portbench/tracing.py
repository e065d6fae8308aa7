"""What a traced run (``--trace 1``) reads, and the readings the per-layer
metrics are computed from.

- the program's spans (``klogs_tpu_torch/obs/trace.py``), sampled at 1
  in the server's process for the window and kept in memory by a sink:
  never the ``--trace-json`` writer;
- the program's counters: its registry's families, read before and after
  the window;
- ``torch.profiler``'s device activity (CUDA only: kernels, copies and
  fills), read from its raw events.

``Trace`` holds what the window saw, clipped to it, for the readers in
``metrics/``; ``breakdown`` gives the run's most costly device operations
and its idle time by what the host was doing.
"""

from dataclasses import dataclass, field

# The engine's spans of host work on the event loop, which label the
# device's idle gaps.
HOST_WORK = ("device.frame", "device.kernel")


@dataclass
class Trace:
    """One traced window. Times are Unix seconds (the profiler's clock
    and the spans' ``start_unix`` are both the host's real-time clock)."""

    t0: float
    t1: float
    spans: "list[dict]" = field(default_factory=list)
    counters: "dict[str, tuple[float, float]]" = field(default_factory=dict)
    # (kind, name, start, end): kind "kernel", "memcpy" or "memset".
    device: "list[tuple[str, str, float, float]]" = field(
        default_factory=list)
    pattern_bytes: int = 0
    peaks: "dict | None" = None
    has_device_trace: bool = False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def spans_named(self, name: str) -> "list[dict]":
        """Spans of ``name`` that started inside the window."""
        return [s for s in self.spans if s["name"] == name
                and self.t0 <= s["start_unix"] < self.t1]

    def batches(self) -> "list[dict]":
        """The engine's outer ``device.frame`` spans, one a device batch
        (its per-bucket children carry no ``staged`` attribute)."""
        return [s for s in self.spans_named("device.frame")
                if s["attrs"].get("staged")]

    def kernels(self) -> "list[tuple[str, str, float, float]]":
        return [e for e in self.device if e[0] == "kernel"]

    def busy_s(self) -> float:
        return union_s([(a, b) for _, _, a, b in self.device])


def union_s(intervals: "list[tuple[float, float]]") -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: "list[tuple[float, float]]", t0: float,
         t1: float) -> "list[tuple[float, float]]":
    """The idle stretches of [t0, t1] between ``intervals``."""
    out, end = [], t0
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < t1:
        out.append((end, t1))
    return out


# -- the program's counters -------------------------------------------

def read_counters(registry) -> "dict[str, tuple[float, float]]":
    """family -> (sum, count) over its children: a histogram's sum and
    count, a counter's or gauge's value and 0."""
    out = {}
    for fam in registry.collect():
        total, count = 0.0, 0.0
        for _, child in fam.children():
            if fam.type == "histogram":
                _, s, c = child.snapshot()
                total += s
                count += c
            else:
                total += child.value
        out[fam.name] = (total, count)
    return out


def counter_delta(before: dict,
                  after: dict) -> "dict[str, tuple[float, float]]":
    return {k: (v[0] - before.get(k, (0.0, 0.0))[0],
                v[1] - before.get(k, (0.0, 0.0))[1])
            for k, v in after.items()}


# -- the device trace -------------------------------------------------

def device_events(prof, t0: float, t1: float
                  ) -> "list[tuple[str, str, float, float]]":
    """The CUDA activity of a stopped ``torch.profiler.profile``, clipped
    to [t0, t1]."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        a = e.start_ns() / 1e9
        b = a + e.duration_ns() / 1e9
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        name = e.name()
        kind = ("memcpy" if name.startswith("Memcpy") else
                "memset" if name.startswith("Memset") else "kernel")
        out.append((kind, name, a, b))
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """``device_ops``: the device operations that took most time in the
    window, [name, seconds]; ``idle_gaps``: the window's idle device time
    by what the host was doing, [label, seconds]: a gap is labelled by the
    engine's host span open at its middle (``device.frame``: the layout
    and staging; ``device.kernel``: a sub-batch's enqueue), else
    ``host: outside the engine`` (gRPC, the RPC's decode and encode, the
    coalescer, the event loop). The spans that only wait (``rpc.server``,
    ``coalescer.dispatch``, ``device.fetch``) name no gap."""
    per_op: "dict[str, float]" = {}
    for _, name, a, b in tr.device:
        per_op[name] = per_op.get(name, 0.0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s["start_unix"], s["start_unix"] + s["duration_s"],
                    s["name"]) for s in tr.spans
                   if s["name"] in HOST_WORK
                   and s.get("duration_s") is not None)
    per_label: "dict[str, float]" = {}
    active: "list[tuple[float, float, str]]" = []
    i = 0
    for a, b in gaps([(x, y) for _, _, x, y in tr.device], tr.t0, tr.t1):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= mid]
        label = (min(active, key=lambda s: s[1] - s[0])[2] if active
                 else "host: outside the engine")
        per_label[label] = per_label.get(label, 0.0) + (b - a)
    idle = sorted(per_label.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
