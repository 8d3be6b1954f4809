"""One reader a metric, found by the metric's name: ``read(rec)`` takes
the run's ``harness.Record`` and returns the value, or None where the run
has nothing to read (the metric is then left out of the result line)."""
