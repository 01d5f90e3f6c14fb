"""Data pipeline of the PyTorch port (its own copy of the JAX package's)."""
