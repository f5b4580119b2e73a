"""One reader a metric, found by the metric's name: ``read(run)`` returns
the metric's value from what ``harness.Run`` holds, or None where the run
holds nothing to read it from (the harness then leaves the metric out)."""
