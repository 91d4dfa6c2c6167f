"""Twins of the JAX package's ``examples/`` scripts, on the port."""
