"""Runtime: per-container fan-out and sinks."""
