"""The benchmark's yardstick: peaks, operation and byte counts, the
reduction of a profiler trace, arrival orders and latency percentiles."""
