"""Static analysis of the port's own source: ``torchlint`` (host syncs,
compiles and CUDA-graph captures in hot loops, state copies per step,
branches on tensor values, collectives over unbound axes)."""
