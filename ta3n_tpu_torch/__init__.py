"""TA3N in PyTorch for one NVIDIA H100: the port of the JAX package
`ta3n_tpu` (its reference, held against it by the tests).

The port runs every model, loss, optimizer and precision configuration
of the JAX package, in float32 or bfloat16 compute (the flagship is the
`trn-m` + TransAttn video model): the serving
path (`serve.Predictor`, `cli.serve`), the train step
(`train.make_train_step`) with features from the host or from stores on
the card, the eval CLI (`cli.test_models`), and the Trainer
(`train.loop.Trainer`) with its train CLI (`cli.train`); the multi-scale
TRN's forward and backward and the store gather + shared FC are
hand-written CUDA kernels (`csrc/`).  ROADMAP.md lists what is still to
port.  The package imports torch and nothing of the JAX package.
"""
