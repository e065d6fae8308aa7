"""Several devices: the data x pattern mesh and the process group."""
