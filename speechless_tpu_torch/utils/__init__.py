"""Host utilities (copies of the JAX package's jax-free `utils` modules)."""
