"""Filter layer: the compiler, the GPU engine and the write gate."""
