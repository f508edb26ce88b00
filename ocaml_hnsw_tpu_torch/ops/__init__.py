"""Tensor ops of the torch port: metrics, quantization, dedup, bitonic
networks, distances, and the CUDA kernels under `ops/kernels`."""
