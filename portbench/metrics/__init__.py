"""Per-layer metric readers, one file per metric named as in
``BENCHMARK.json``: ``read(summary)`` returns the metric from a traced
run's summary, or None where the run has nothing for it to read.  Files
whose names start with ``_`` hold the arithmetic the readers share."""
