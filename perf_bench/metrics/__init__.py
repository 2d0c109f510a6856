"""Per-layer metric readers, one file per metric named as in
``BENCHMARK.json``: ``read(run)`` returns the metric from the run's spans,
counters, series or device trace, or None where the run has nothing to
read.  ``counts`` holds the operation and byte counts they divide by."""
