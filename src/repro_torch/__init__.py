"""PyTorch/CUDA port of the TrainMover runtime (the JAX package `repro`
is the reference). Subpackages mirror `repro`; causal attention runs in
hand-written CUDA kernels (kernels/csrc)."""
