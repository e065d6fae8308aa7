"""Per-layer metric readers: ``<metric>.py`` a metric of
``BENCHMARK.json``'s ``per_layer``, each with ``read(trace)`` (a
``portbench.tracing.Trace``) returning the value, or None where the
window holds nothing to read."""
