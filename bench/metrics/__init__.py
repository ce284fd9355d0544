"""Per-layer metric readers, one module a metric, named as the metric in
``BENCHMARK.json``; each ``read(run)`` returns the number or None where
the run holds nothing to read."""
