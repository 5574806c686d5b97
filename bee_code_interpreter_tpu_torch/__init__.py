"""PyTorch/CUDA port of the accelerator half of bee_code_interpreter_tpu.

The JAX package stays the reference; this package imports nothing of it.
It serves the llama-style decoder, dense or Mixture-of-Experts, with paged
continuous batching (one-shot, chunked, prefix-cached and interleaved
admission; bf16 or int8 KV pools), decodes it with a contiguous cache
(``Transformer.generate_cached``), trains it and loads HF Llama checkpoints
(``models/``), with hand-written Hopper kernels for the flash attention
forward and backward (head dim 64 or 128) and the paged decode attention
(``ops/``). The vision family trains too: the ViT (``models/vit.py``, its
attention through the flash kernels), the ResNet (``models/vision.py``) and
the data-parallel MNIST MLP (``models/mnist.py``). Serving is
observable as in the JAX package: metrics, per-request traces, step
records, first calls of its programs, device memory and profiler captures
(``observability/``, ``utils/metrics.py``), and measured by
``models/serving_bench.py``.
"""
