"""Device ops: program packing, classification and the NFA kernels."""
