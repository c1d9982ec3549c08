"""Hand-written kernels and the temporal-graph block."""
