"""The port's own copy of `ta3n_tpu/io_utils/logs.py`.

Metrics meters and the reference's log-file layout.

Parity: AverageMeter (main.py:772-787); train/val log files with the
append-mode resume separator (main.py:110-131) and best.log
(main.py:127,278).
"""

from __future__ import annotations

import os
from typing import Dict, TextIO

__all__ = ["AverageMeter", "LogFiles"]


class AverageMeter:
    """Computes and stores the average and current value (main.py:772-787)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


class LogFiles:
    """train.log / train_short.log / val.log / val_short.log (+ best.log).

    Opened append-mode with a '========== start: N' separator on resume
    (main.py:112-120), write-mode otherwise.
    """

    NAMES = ("train.log", "train_short.log", "val.log", "val_short.log")

    def __init__(self, path_exp: str, resume: bool = False,
                 start_epoch: int = 1, best_log: str = "best.log"):
        os.makedirs(path_exp, exist_ok=True)
        mode = "a" if resume else "w"
        self.files: Dict[str, TextIO] = {
            name: open(os.path.join(path_exp, name), mode)
            for name in self.NAMES
        }
        if resume:
            for f in self.files.values():
                f.write(f"========== start: {start_epoch}\n")
        self.best_file = open(best_log, "a")

    def write(self, name: str, line: str):
        f = self.files[name]
        f.write(line if line.endswith("\n") else line + "\n")
        f.flush()

    def write_best(self, value: float):
        self.best_file.write("%.3f\n" % value)
        self.best_file.flush()

    def write_total_time(self, seconds: float):
        line = "total time: {:.3f} ".format(seconds)
        for f in self.files.values():
            f.write(line)

    def close(self):
        for f in self.files.values():
            f.close()
        self.best_file.close()
