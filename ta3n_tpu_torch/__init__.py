"""TA3N in PyTorch for one NVIDIA H100: the port of the JAX package
`ta3n_tpu` (its reference, held against it by the tests).

The port so far is the flagship serving path (`serve.Predictor` and
`cli.serve`) and the flagship train step (`train.make_train_step`) over
the `trn-m` + TransAttn video model, with the multi-scale TRN's forward
and backward as hand-written CUDA kernels (`csrc/`).  ROADMAP.md lists
what is still to port.  The package imports torch and nothing of the JAX
package.
"""
