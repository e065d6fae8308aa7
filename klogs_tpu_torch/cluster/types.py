"""Cluster data model (counterpart of ``klogs_tpu/cluster/types.py``).

Minimal projections of the Kubernetes objects klogs touches: pods with
their ready state and containers, and the server-side log options
(``v1.PodLogOptions``: since, tail, follow, previous, timestamps and
since-time).
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ContainerInfo:
    name: str
    init: bool = False


@dataclass
class PodInfo:
    name: str
    namespace: str
    labels: dict[str, str] = field(default_factory=dict)
    ready: bool = True
    containers: list[ContainerInfo] = field(default_factory=list)
    init_containers: list[ContainerInfo] = field(default_factory=list)


@dataclass
class LogOptions:
    """Server-side log options; the backend (kubelet analog) applies them."""

    since_seconds: int | None = None
    tail_lines: int | None = None
    follow: bool = False
    container: str = ""
    # Logs of the previous terminated instance, an RFC3339 stamp before
    # each line, and an absolute RFC3339 lower bound.
    previous: bool = False
    timestamps: bool = False
    since_time: str | None = None


def match_label_selector(labels: dict[str, str], selector: str) -> bool:
    """Kubernetes equality-based label selector: "k=v,k2=v2" (also k==v,
    k!=v, bare k for existence and !k for absence)."""
    for term_ in selector.split(","):
        term_ = term_.strip()
        if not term_:
            continue
        if "!=" in term_:
            k, v = term_.split("!=", 1)
            if labels.get(k.strip()) == v.strip():
                return False
        elif "==" in term_:
            k, v = term_.split("==", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        elif "=" in term_:
            k, v = term_.split("=", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        elif term_.startswith("!"):
            if term_[1:].strip() in labels:
                return False
        elif term_ not in labels:
            return False
    return True
