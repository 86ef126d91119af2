"""Tensor ops of the port: masking, similarity, the inference towers, and
the hand-written CUDA kernels under `kernels/`."""
