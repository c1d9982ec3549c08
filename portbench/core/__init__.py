"""The harness: finds a cell's files by name, runs its driver, reduces the
trace, reads the per-layer metrics and prints the result line."""
