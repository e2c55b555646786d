"""RNN (LSTM/GRU) frame aggregation.

Port of `ta3n_tpu/models/rnn.py` (reference aggregate_frames' 'rnn'
branch, models.py:392-422): the S frame features are max-pooled into
``n_ts`` chunks, an LSTM or GRU (bidirectional with ``n_directions`` 2,
``n_rnn`` layers, hidden ``shared_dim // n_directions`` per direction)
runs over the chunks from a zero initial state, and the last time step's
output is the video feature.

The recurrent net is torch's ``nn.LSTM`` / ``nn.GRU`` (cuDNN's RNN on the
card: the JAX package's is a ``lax.scan``, not a Pallas kernel).  The
model holds it as ``rnn``, so that its parameters carry the reference's
names (``rnn.weight_ih_l0``, ``rnn.bias_hh_l1_reverse``, ...) and a
reference checkpoint strict-loads.  Weights take kaiming-normal init
(models.py:210-212), biases torch's RNN default U(±1/sqrt(hidden)); both
bias vectors are kept, as torch and the JAX package keep them.  The net
runs through `layers.cudnn_f32`: float32 whatever
``torch.backends.cudnn.allow_tf32`` says.

Under ``compute_dtype="bfloat16"`` the chunk maxima are taken on the
bfloat16 frame features and the recurrent net runs in float32, with a
float32 video feature, as in the JAX package: its scans compute
``x @ w_ih`` with float32 parameters, which promotes the bfloat16 input
(`ta3n_tpu/models/rnn.py:52-75, 111`).  So ``cudnn_f32`` keeps its one
meaning under bfloat16 as well: float32 on cuDNN with TF32 off (TF32 has
no bearing on a bfloat16 product, and none is made here).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ta3n_tpu_torch.config import ModelConfig
from ta3n_tpu_torch.models.layers import cudnn_f32

__all__ = ["build_rnn", "chunk_frames", "rnn_aggregate"]


def build_rnn(cfg: ModelConfig,
              generator: Optional[torch.Generator]) -> nn.RNNBase:
    """The LSTM or GRU of ``cfg`` on the CPU, initialised from
    ``generator`` without a draw from torch's global RNG."""
    cells = {"LSTM": nn.LSTM, "GRU": nn.GRU}
    if cfg.rnn_cell not in cells:
        raise ValueError(f"unknown rnn_cell {cfg.rnn_cell}")
    hidden = cfg.shared_dim // cfg.n_directions
    with torch.device("meta"):
        rnn = cells[cfg.rnn_cell](cfg.shared_dim, hidden,
                                  num_layers=cfg.n_rnn, batch_first=True,
                                  bidirectional=cfg.n_directions == 2)
    rnn = rnn.to_empty(device="cpu")
    bound = 1.0 / math.sqrt(hidden)
    with torch.no_grad():
        for name, p in rnn.named_parameters():
            if name.startswith("weight_"):
                nn.init.kaiming_normal_(p, generator=generator)
            else:
                p.uniform_(-bound, bound, generator=generator)
    return rnn


def chunk_frames(feat_seg: torch.Tensor, n_ts: int) -> torch.Tensor:
    """[B, S, D] -> [B, n_ts, D]: len_ts = round(S / n_ts) frames a chunk
    (Python's round, half to even, as the JAX package's), the frames
    truncated to len_ts * n_ts or the last frame repeated up to it, then
    the max over each chunk (models.py:396-408).  ``amax`` shares the
    gradient between tied maxima, as ``jnp.max`` does."""
    s = feat_seg.shape[1]
    len_ts = max(round(s / n_ts), 1)
    extra = len_ts * n_ts - s
    x = feat_seg
    if extra < 0:
        x = x[:, :len_ts * n_ts]
    elif extra > 0:
        x = torch.cat([x, x[:, -1:].expand(-1, extra, -1)], dim=1)
    return x.reshape(x.shape[0], n_ts, len_ts, -1).amax(dim=2)


def rnn_aggregate(rnn: nn.RNNBase, feat_seg: torch.Tensor,
                  n_ts: int) -> torch.Tensor:
    """The video feature [B, H * n_directions] of frame features
    feat_seg [B, S, D]: the chunk maxima through ``rnn`` from a zero
    state, its output at the last time step (models.py:409-422), in
    float32 whatever feat_seg's dtype."""
    x = chunk_frames(feat_seg, n_ts).float()
    out = cudnn_f32(lambda t: rnn(t)[0], x, tuple(rnn.parameters()))
    return out[:, -1]
