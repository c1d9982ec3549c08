"""Weight bridge from the JAX package."""
