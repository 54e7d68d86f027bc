"""Exchanges and partitioning of the port (see each module for its JAX
counterpart)."""
