"""Quantitative evaluation harness of the PyTorch port (the JAX package's four stages)."""
