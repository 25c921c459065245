"""The plain reference the benchmark judges the system by: imports nothing
of the system, jax or the JAX package."""
