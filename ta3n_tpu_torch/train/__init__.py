"""Training of the port: the flagship train step (`train/step.py`), its
optimizer (`train/optim.py`) and schedules (`train/schedules.py`)."""

from ta3n_tpu_torch.train.step import (StepScalars, TrainState,
                                       create_train_state, make_train_step)

__all__ = ["TrainState", "StepScalars", "create_train_state",
           "make_train_step"]
