"""Host-side preprocessing of the PyTorch port."""
