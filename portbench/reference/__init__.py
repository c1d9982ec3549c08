"""Plain float32 PyTorch reference of the benchmark's cells: the models,
the graph block and its noise draw, the augmentation, the MoCo steps, and
the comparison that decides ``correct``.  Nothing here imports the measured
program, JAX or the JAX package."""
