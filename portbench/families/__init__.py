"""How the benchmark builds each model family of the port under test."""
