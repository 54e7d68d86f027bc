"""Logical plans, pruning and the planner of the port (see each module
for its JAX counterpart)."""
