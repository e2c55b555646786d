"""TA3N in PyTorch for one NVIDIA H100: the port of the JAX package
`ta3n_tpu` (its reference, held against it by the tests).

The port runs every model, loss, optimizer and precision configuration
of the JAX package, in float32 or bfloat16 compute (the flagship is the
`trn-m` + TransAttn video model): the serving
path (`serve.Predictor`, `cli.serve`), the train step
(`train.make_train_step`) with features from the host or from stores on
the card, the eval CLI (`cli.test_models`), and the Trainer
(`train.loop.Trainer`) with its train CLI (`cli.train`), ensembles of N
members in one step (`train.ensemble`) with the sweep runner and CLI
(`train.sweep`, `cli.sweep`) and deep-ensemble serving; int8
inference, AOT serving artifacts (`Predictor.export`) and feature
extraction on the card (`models.backbones`, `prep.video2feature`); the
train CLI's profiler window and tensorboard embeddings, the native host
gather (`data.native_gather`) and the data-preparation tools
(`cli.convert_features`, `prep`; `python -m ta3n_tpu_torch` lists every
entry point); data parallelism over cards, one process a card in a
`torch.distributed` group for training and one process over every card
for eval and serving (`parallel`); the
multi-scale TRN's forward and backward and the store gather + shared FC
are hand-written CUDA kernels (`csrc/`).  ROADMAP.md lists what is still to
port.  The package imports torch and nothing of the JAX package.
"""
