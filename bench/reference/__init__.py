"""Plain PyTorch integer references of the benchmark's models (no program import)."""
