"""PyTorch/CUDA port of the accelerator half of bee_code_interpreter_tpu.

The JAX package stays the reference; this package imports nothing of it.
Its first slice is paged continuous-batching serving of the llama-style
decoder (``models/``) with hand-written Hopper kernels for the flash
prefill and the paged decode attention (``ops/``).
"""
