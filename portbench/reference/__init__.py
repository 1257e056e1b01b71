"""The plain reference of the benchmark: NumPy and plain PyTorch, no module
of the program, of its JAX original or of JAX."""
