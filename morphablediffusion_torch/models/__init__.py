"""Models of the PyTorch port (channels-first inside; see each module)."""
