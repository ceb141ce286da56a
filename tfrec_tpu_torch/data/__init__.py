"""Seeded data generators of the port (numpy copies of the reference's)."""
