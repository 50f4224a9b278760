"""The benchmark's yardstick: cells, peaks, operation counts, traces."""
