"""The benchmark's yardstick: traffic, weights, drivers, traces, counts, checks."""
