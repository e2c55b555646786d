"""The port's own copy of `ta3n_tpu/io_utils/confusion.py`.

Confusion matrices, per-class top-K accuracy, and the PNG plot.

Parity: test_models.py:198-229 + utils/utils.py:13-51, without sklearn
(plain numpy bincount) and with matplotlib gated (headless optional dep).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["confusion_matrix", "per_class_topk_accuracy",
           "plot_confusion_matrix"]


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    idx = y_true * num_classes + y_pred
    cm = np.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def per_class_topk_accuracy(y_true: np.ndarray, topk_preds: np.ndarray,
                            num_classes: int,
                            tops: Sequence[int]) -> List[np.ndarray]:
    """Per-class accuracy at each K (test_models.py:204-206 semantics:
    cls_hit[:k] sums the diagonal of the per-rank confusion matrices)."""
    cms = [confusion_matrix(y_true, topk_preds[:, k], num_classes)
           for k in range(topk_preds.shape[1])]
    cls_cnt = np.maximum(cms[0].sum(axis=1), 1)
    cls_hit = np.array([np.diag(c) for c in cms])
    return [cls_hit[:k].sum(axis=0) / cls_cnt for k in tops]


def plot_confusion_matrix(path: str, cm: np.ndarray, classes: Sequence[str],
                          normalize: bool = False,
                          title: str = "Confusion matrix") -> None:
    """Render the confusion-matrix PNG (utils/utils.py:13-51)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # matplotlib not in the image: write a .txt instead
        np.savetxt(path + ".txt", cm, fmt="%d")
        return

    counts = cm.sum(axis=1).astype(np.float64)
    counts[counts == 0] = 1
    cmx = cm.astype("float") / counts[:, None] if normalize \
        else cm.astype("float")

    plt.figure(figsize=(13, 10))
    plt.imshow(cmx, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title(title)
    plt.colorbar()
    ticks = np.arange(len(classes))
    plt.xticks(ticks, classes, rotation=90)
    plt.yticks(ticks, classes)
    factor = 100 if normalize else 1
    fmt = ".0f" if normalize else "d"
    thresh = cmx.max() / 2.0
    for i in range(cmx.shape[0]):
        for j in range(cmx.shape[1]):
            plt.text(j, i, format(cmx[i, j] * factor, fmt),
                     horizontalalignment="center",
                     color="white" if cmx[i, j] > thresh else "black")
    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    plt.savefig(path)
    plt.close()
