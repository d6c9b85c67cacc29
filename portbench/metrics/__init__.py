"""Per-layer metric readers: `<name>.py` for each per-layer metric of
BENCHMARK.json, found by name. Each has `read(r)`, where `r` is the run's
`portbench.readings.Readings`, and returns the metric's value, or None
where the run holds nothing for it to read."""
