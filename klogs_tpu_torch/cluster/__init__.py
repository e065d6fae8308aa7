"""Cluster access: the backend seam and the hermetic fake cluster."""
