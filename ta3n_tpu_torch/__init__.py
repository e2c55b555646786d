"""TA3N in PyTorch for one NVIDIA H100: the port of the JAX package
`ta3n_tpu` (its reference, held against it by the tests).

The port so far is the flagship serving path: `serve.Predictor` and
`cli.serve` over the `trn-m` + TransAttn video model, with the multi-scale
TRN forward as a hand-written CUDA kernel (`csrc/trn_fused_fwd.cu`).
ROADMAP.md lists what is still to port.  The package imports torch and
never jax.
"""
