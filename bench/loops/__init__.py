"""loops of the benchmark, found by name (see harness.load)."""
