"""Hand-written kernels of the torch port and their plain versions."""
