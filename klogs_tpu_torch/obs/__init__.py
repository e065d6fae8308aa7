"""klogs_tpu_torch.obs: the port's observability layer.

Counterpart of ``klogs_tpu/obs``: the metrics core (Counter, Gauge,
Histogram, Registry), the inventory of every family, the Prometheus
exposition and JSON snapshots, the HTTP sidecar, the tracer and flight
recorder (``obs.trace``) and the pipeline profiler (``obs.profiler``).
"""

from klogs_tpu_torch.obs.expo import render, snapshot
from klogs_tpu_torch.obs.http import Health, MetricsHTTPServer
from klogs_tpu_torch.obs.inventory import (
    PORT_FAMILIES,
    SPECS,
    register_all,
)
from klogs_tpu_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Family,
    Gauge,
    Histogram,
    Registry,
)

__all__ = [
    "REGISTRY", "Registry", "Family", "Counter", "Gauge", "Histogram",
    "Health", "MetricsHTTPServer", "PORT_FAMILIES", "SPECS", "register_all",
    "render", "snapshot",
]
