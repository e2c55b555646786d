"""TensorBoard embedding / scalar logging: the port's own copy of
`ta3n_tpu/io_utils/tensorboard.py`.

Parity with the reference's tensorboardX usage (main.py:64-65,630-664,
752-756): per-epoch embeddings of video-level features tagged by class and
by domain, a 3-class highlight view, and best-accuracy text.  Gated import
— a no-op writer is returned when tensorboardX is unavailable.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["EmbeddingWriter"]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class EmbeddingWriter:
    def __init__(self, logdir: Optional[str]):
        self._writer = None
        if logdir is not None:
            try:
                from tensorboardX import SummaryWriter
                self._writer = SummaryWriter(logdir)
            except ImportError:
                pass
        self.reset()

    @property
    def active(self) -> bool:
        return self._writer is not None

    def reset(self):
        self._feat_s, self._lab_s = [], []
        self._feat_t, self._lab_t = [], []

    def collect(self, feat_source, labels_source, feat_target,
                labels_target, mask_s=None, mask_t=None):
        """Accumulate one batch of video-level features (feat[1] in the
        reference, main.py:430-435); numpy arrays or tensors on any
        device."""
        if not self.active:
            return

        def keep(f, l, m):
            f, l = _host(f), _host(l)
            if m is not None:
                sel = _host(m) > 0
                f, l = f[sel], l[sel]
            return f, l

        fs, ls = keep(feat_source, labels_source, mask_s)
        ft, lt = keep(feat_target, labels_target, mask_t)
        self._feat_s.append(fs)
        self._lab_s.append(ls)
        self._feat_t.append(ft)
        self._lab_t.append(lt)

    def write_epoch(self, global_step: int,
                    highlight_classes=(1, 3, 11)):
        """Write train_source / train_target / train_DA / train_DA_labels
        embeddings (main.py:630-664)."""
        if not self.active or not self._feat_s:
            self.reset()
            return
        fs = np.concatenate(self._feat_s)
        ls = np.concatenate(self._lab_s)
        ft = np.concatenate(self._feat_t)
        lt = np.concatenate(self._lab_t)
        w = self._writer
        w.add_embedding(torch.from_numpy(fs), metadata=ls.tolist(),
                        global_step=global_step, tag="train_source")
        w.add_embedding(torch.from_numpy(ft), metadata=lt.tolist(),
                        global_step=global_step, tag="train_target")
        fa = np.concatenate([fs, ft])
        dom = np.concatenate([np.zeros(len(fs)), np.ones(len(ft))])
        w.add_embedding(torch.from_numpy(fa), metadata=dom.tolist(),
                        global_step=global_step, tag="train_DA")
        # highlight view: selected classes only, distinct ids per
        # class x domain (main.py:643-664)
        labels_new_s = np.zeros(len(ls), dtype=np.int64)
        labels_new_t = np.zeros(len(lt), dtype=np.int64)
        for rank, c in enumerate(highlight_classes):
            labels_new_s[ls == c] = rank + 1
            labels_new_t[lt == c] = rank + 1 + len(highlight_classes)
        sel_s = labels_new_s != 0
        sel_t = labels_new_t != 0
        if sel_s.any() or sel_t.any():
            f_new = np.concatenate([fs[sel_s], ft[sel_t]])
            l_new = np.concatenate([labels_new_s[sel_s],
                                    labels_new_t[sel_t]])
            w.add_embedding(torch.from_numpy(f_new), metadata=l_new.tolist(),
                            global_step=global_step, tag="train_DA_labels")
        self.reset()

    def write_val_embedding(self, feat, labels, global_step: int):
        if not self.active:
            return
        w = self._writer
        w.add_embedding(torch.from_numpy(_host(feat)),
                        metadata=_host(labels).tolist(),
                        global_step=global_step, tag="validation")

    def write_best_text(self, best: float, epoch: int):
        if self.active:
            self._writer.add_text("Best_Accuracy", str(best), epoch)

    def close(self):
        if self.active:
            self._writer.close()
