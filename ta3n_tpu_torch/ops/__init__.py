"""Ops of the port: the relation plan, the gradient-reversal layer and the
fused multi-scale TRN (plain versions and CUDA kernels: the inference
forward, the training forward and the backward)."""
