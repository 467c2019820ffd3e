"""Per-layer metric readers, one module a metric, found by the metric's
name in BENCHMARK.json (the file is named after it). Each `read(trace)`
takes the traced run's `trace.Trace` and returns the value, or None where
it finds nothing to read; the run then leaves the metric out."""
