"""Utilities of the PyTorch port (training-state checkpoints)."""
