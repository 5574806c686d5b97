"""Attention kernels, their plain versions, and the paged KV cache."""
