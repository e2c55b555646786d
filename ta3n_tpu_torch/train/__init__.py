"""Training of the port: the flagship train step, with features from the
host or gathered from stores on the device, and the validation steps
(`train/step.py`), its optimizer (`train/optim.py`) and schedules
(`train/schedules.py`)."""

from ta3n_tpu_torch.train.step import (StepScalars, TrainState,
                                       create_train_state, device_gather,
                                       make_eval_step, make_multi_eval_step,
                                       make_train_step, topk_correct)

__all__ = ["TrainState", "StepScalars", "create_train_state",
           "make_train_step", "make_eval_step", "make_multi_eval_step",
           "device_gather", "topk_correct"]
