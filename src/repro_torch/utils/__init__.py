"""Framework-neutral helpers carried from the JAX package."""
