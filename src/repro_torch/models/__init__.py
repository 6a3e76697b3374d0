"""Model-level integer encoder of the port."""
