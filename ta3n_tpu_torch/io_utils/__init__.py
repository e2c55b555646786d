"""Files of the port: weight conversion between the JAX package,
reference-format `.pth.tar` checkpoints and the port's modules
(`convert.py`), the Trainer's checkpoints (`checkpoint.py`), log files and
meters (`logs.py`), confusion matrices (`confusion.py`) and the
tensorboard embedding writer (`tensorboard.py`)."""
