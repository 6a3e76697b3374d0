"""Integer quantization primitives of the port."""
