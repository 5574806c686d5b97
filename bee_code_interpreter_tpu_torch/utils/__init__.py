"""Utilities of the PyTorch port: training-state checkpoints, the metrics
registry and the first-call wrappers of the batcher's programs."""
