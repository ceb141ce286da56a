"""Tensor operations of the port (embedding primitives)."""
