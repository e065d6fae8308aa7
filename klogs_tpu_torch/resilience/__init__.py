"""Failure-handling policy (copy of ``klogs_tpu/resilience/policy.py``)."""
