"""The plain reference the benchmark judges the system by (each describe
net's reference is its module in ``portbench/nets/``): imports nothing of
the system, jax or the JAX package."""
