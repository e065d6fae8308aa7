"""Prometheus text exposition (format 0.0.4) and JSON snapshots.

Counterpart of ``klogs_tpu/obs/expo.py``. ``render`` walks a Registry
into the text format a Prometheus scrape expects; ``snapshot`` makes the
JSON-able dict behind ``--stats-json``. Both read the same families.
"""

from typing import TYPE_CHECKING, Iterable, Sequence

if TYPE_CHECKING:
    from klogs_tpu_torch.obs.metrics import Registry


def _fmt(v: "float | int") -> str:
    """Integral floats render without the '.0' (parsers take either;
    the text stays stable)."""
    if isinstance(v, float) and v == int(v) and abs(v) < 2**53:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labelstr(names: Sequence[str], values: Sequence[str],
              extra: Iterable[tuple] = ()) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    pairs.extend(extra)
    if not pairs:
        return ""
    body = ",".join(f'{n}="{_escape_label(str(v))}"' for n, v in pairs)
    return "{" + body + "}"


def _exemplar_str(ex: "tuple[dict, float, float] | None") -> str:
    """The OpenMetrics exemplar suffix of a bucket sample, linking the
    observation to its trace (` # {trace_id="..",span_id=".."} v ts`);
    empty when the bucket recorded none."""
    if ex is None:
        return ""
    labels, value, ts = ex
    body = ",".join(f'{k}="{_escape_label(str(v))}"'
                    for k, v in labels.items())
    return f" # {{{body}}} {_fmt(value)} {_fmt(round(ts, 3))}"


def render(registry: "Registry", exemplars: bool = False) -> str:
    """Registry -> Prometheus text exposition. By default strict text
    format 0.0.4 (its parser rejects anything after a sample value);
    ``exemplars=True`` (the sidecar's /metrics?exemplars=1) appends
    OpenMetrics exemplars to the bucket samples that recorded one."""
    out: list[str] = []
    for fam in registry.collect():
        out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.type}")
        for labelvalues, child in fam.children():
            lab = _labelstr(fam.labelnames, labelvalues)
            if fam.type == "histogram":
                counts, total, n = child.snapshot()
                ex = child.exemplars() if exemplars else {}
                cum = 0
                for i, (bound, c) in enumerate(zip(child.buckets, counts)):
                    cum += c
                    le = _labelstr(fam.labelnames, labelvalues,
                                   extra=(("le", _fmt(float(bound))),))
                    out.append(f"{fam.name}_bucket{le} {cum}"
                               + _exemplar_str(ex.get(i)))
                inf = _labelstr(fam.labelnames, labelvalues,
                                extra=(("le", "+Inf"),))
                out.append(f"{fam.name}_bucket{inf} {n}"
                           + _exemplar_str(ex.get(len(child.buckets))))
                out.append(f"{fam.name}_sum{lab} {_fmt(total)}")
                out.append(f"{fam.name}_count{lab} {n}")
            else:
                out.append(f"{fam.name}{lab} {_fmt(child.value)}")
    return "\n".join(out) + "\n"


def snapshot(registry: "Registry") -> dict:
    """Registry -> JSON-able dict (--stats-json). Histograms carry
    bucket bounds and counts, sum, count and the reservoir's p50, p90
    and p99; a labeled family lists one sample per child."""
    doc: dict = {}
    for fam in registry.collect():
        samples = []
        for labelvalues, child in fam.children():
            labels = dict(zip(fam.labelnames, labelvalues))
            if fam.type == "histogram":
                counts, total, n = child.snapshot()
                sample = {"buckets": dict(zip(
                    (_fmt(float(b)) for b in child.buckets), counts)),
                    "sum": total, "count": n,
                    "p50": child.percentile(50),
                    "p90": child.percentile(90),
                    "p99": child.percentile(99)}
            else:
                sample = {"value": child.value}
            if labels:
                sample["labels"] = labels
            samples.append(sample)
        doc[fam.name] = {"type": fam.type, "help": fam.help,
                         "samples": samples}
    return doc
