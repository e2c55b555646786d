"""Ops of the port: the relation plan, the gradient-reversal layer and the
fused multi-scale TRN forward (plain version and CUDA kernel)."""
