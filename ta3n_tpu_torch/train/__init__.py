"""Training of the port: the train step, with features from the
host or gathered from stores on the device, its K-steps-per-call forms,
the validation and inference steps (`train/step.py`), its optimizer
(`train/optim.py`), schedules (`train/schedules.py`) and the Trainer's
epoch loop (`train/loop.py`)."""

from ta3n_tpu_torch.train.step import (StepScalars, TrainState,
                                       create_train_state, device_gather,
                                       make_eval_step, make_infer_step,
                                       make_multi_eval_step,
                                       make_multi_train_step,
                                       make_sampled_multi_step,
                                       make_sampled_shard_multi_step,
                                       make_train_step, topk_correct)

__all__ = ["TrainState", "StepScalars", "create_train_state",
           "make_train_step", "make_multi_train_step",
           "make_sampled_multi_step", "make_sampled_shard_multi_step",
           "make_eval_step", "make_multi_eval_step", "make_infer_step",
           "device_gather", "topk_correct"]
