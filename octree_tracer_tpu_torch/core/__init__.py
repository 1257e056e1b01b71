"""Node formats shared with the JAX package."""
