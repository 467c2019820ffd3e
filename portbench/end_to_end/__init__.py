"""End-to-end metric readers, one module a metric, found by the metric's
name in BENCHMARK.json. Each `read(window)` takes the run's `Window`
(run.py) and returns the value, or None where the cell has none."""
