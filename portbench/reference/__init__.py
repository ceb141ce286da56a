"""Plain PyTorch references of the benchmark's models; nothing of the port."""
