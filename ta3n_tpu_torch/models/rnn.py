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
``torch.backends.cudnn.allow_tf32`` says.  Under a ``torch.func``
transform (the ensembles) it runs as ``recurrence``, the same recurrence
in plain tensor ops, which vmap batches over members.

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

__all__ = ["build_rnn", "chunk_frames", "recurrence", "rnn_aggregate"]


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
    if torch._C._are_functorch_transforms_active():
        # cuDNN's and oneDNN's RNN have no batching rule (an inference
        # pass under vmap cannot run them at all): the recurrence itself
        return recurrence(rnn, x)[:, -1]
    out = cudnn_f32(lambda t: rnn(t)[0], x, tuple(rnn.parameters()))
    return out[:, -1]


def recurrence(rnn: nn.RNNBase, x: torch.Tensor) -> torch.Tensor:
    """``rnn(x)[0]`` from a zero state in plain tensor ops, a step at a
    time (the JAX package's scan): the output [B, T, H * n_directions] of
    the last layer, each direction's hidden states side by side.  Gates in
    torch's order and form: LSTM (i, f, g, o), GRU (r, z, n) with
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)).  It reads the
    parameters by name, so under ``torch.func.functional_call`` it reads
    the ones passed in; the ensembles (`train/ensemble.py`, `serve.py`)
    run it under vmap, where every op here has a batching rule."""
    lstm = isinstance(rnn, nn.LSTM)
    for layer in range(rnn.num_layers):
        outs = []
        for reverse in range(2 if rnn.bidirectional else 1):
            sfx = f"_l{layer}" + ("_reverse" if reverse else "")
            w_ih, w_hh, b_ih, b_hh = (getattr(rnn, f"{n}{sfx}") for n in (
                "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            gi = x @ w_ih.T + b_ih                     # [B, T, gates * H]
            h = x.new_zeros(x.shape[0], rnn.hidden_size)
            c = torch.zeros_like(h)
            steps = []
            for t in (reversed(range(x.shape[1])) if reverse
                      else range(x.shape[1])):
                gh = h @ w_hh.T + b_hh
                if lstm:
                    i, f, g, o = (gi[:, t] + gh).chunk(4, dim=-1)
                    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                    h = torch.sigmoid(o) * torch.tanh(c)
                else:
                    ir, iz, i_n = gi[:, t].chunk(3, dim=-1)
                    hr, hz, h_n = gh.chunk(3, dim=-1)
                    r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
                    h = (1 - z) * torch.tanh(i_n + r * h_n) + z * h
                steps.append(h)
            if reverse:
                steps.reverse()
            outs.append(torch.stack(steps, dim=1))
        x = torch.cat(outs, dim=-1)
    return x
