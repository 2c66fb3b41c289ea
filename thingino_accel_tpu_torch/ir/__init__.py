"""Graph IR: what importers produce and the engine consumes (the port's own
copy, so that it imports nothing of the JAX package)."""
