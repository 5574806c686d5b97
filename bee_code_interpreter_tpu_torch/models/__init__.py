"""Model family of the PyTorch port."""
