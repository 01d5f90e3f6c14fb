"""Training of the PyTorch port: LR schedule and the one-card trainer."""
