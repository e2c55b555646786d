"""Losses of the port: the entropy that TransAttn needs, the losses of
the train step and the discrepancy family (DAN's RBF MMD, JAN, CORAL).

Ports of `ta3n_tpu/losses/losses.py:38-322`, with optional row masks in
place of the reference's dummy-row padding (`main.py:358-372,825-832`):
padded rows carry zero weight.  The discrepancy losses are torch ops, as
the JAX package leaves them to XLA; their pairwise distances are taken by
direct difference (see ``gaussian_kernel``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["masked_mean", "entropy_from_logits", "weighted_cross_entropy",
           "cross_entropy_soft", "attentive_entropy", "dis_MCD",
           "mmd_linear", "gaussian_kernel", "mmd_rbf", "JAN", "CORAL",
           "loss_adaptive_weight", "rand_select_batch"]


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Mean of ``x`` over rows where ``mask`` is 1 (mean of all if None)."""
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-row Shannon entropy of softmax(logits): sum(-p * log p, -1).

    Port of `ta3n_tpu/losses/losses.py::entropy_from_logits` (reference
    loss.py:8-12, models.py:351-357).
    """
    logp = torch.log_softmax(logits, dim=-1)
    return torch.sum(-logp.exp() * logp, dim=-1)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Class-weighted CE with torch ``nn.CrossEntropyLoss(weight=w)``
    semantics, the weighted mean sum_i w[y_i]*nll_i / sum_i w[y_i]
    (reference main.py:204-206); rows with mask 0 carry no weight."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    if class_weights is not None:
        w = class_weights.to(nll.dtype)[labels.long()]
    else:
        w = torch.ones_like(nll)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return (w * nll).sum() / w.sum().clamp(min=1e-12)


def cross_entropy_soft(pred: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean self-entropy of softmax(pred), target-entropy minimisation
    (reference loss.py:8-12, used at main.py:542-545)."""
    return masked_mean(entropy_from_logits(pred), mask)


def attentive_entropy(pred: torch.Tensor, pred_domain: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Entropy of the class logits weighted by (1 + entropy of the domain
    prediction) (reference loss.py:15-25, used at main.py:558-562 with the
    video-level domain logits)."""
    weights = 1.0 + entropy_from_logits(pred_domain)
    return masked_mean(weights * entropy_from_logits(pred), mask)


def dis_MCD(out1: torch.Tensor, out2: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |softmax(out1) - softmax(out2)| over the real rows, the MCD
    discrepancy (reference loss.py:29-30)."""
    d = (torch.softmax(out1, dim=-1) - torch.softmax(out2, dim=-1)).abs()
    if mask is None:
        return d.mean()
    m = mask.to(d.dtype)[:, None]
    return (d * m).sum() / (m.sum() * d.shape[-1]).clamp(min=1.0)


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    """Trailing dims flattened: the MMD family is defined on [n, d] rows
    (the JAX package flattens where the reference reduces over a middle
    axis, loss.py:51)."""
    return x.reshape(x.shape[0], -1)


def mmd_linear(f_of_X: torch.Tensor, f_of_Y: torch.Tensor) -> torch.Tensor:
    """Linear-kernel MMD (reference loss.py:33-44; the train loop does not
    use it)."""
    delta = _as_2d(f_of_X) - _as_2d(f_of_Y)
    return (delta @ delta.T).mean()


def _pairwise_sq_dist(total: torch.Tensor) -> torch.Tensor:
    """[n, n] squared L2 distances of the rows of ``total`` [n, d] by
    direct difference, subtract then square (reference loss.py:49-52),
    never the GEMM expansion |x|^2 + |y|^2 - 2xy (nor ``torch.cdist``,
    which switches to it above 25 rows): the expansion cancels when the
    distances are small against the row norms, the regime of the
    normal(0.001) init (tests/test_losses.py:213-235).  The [n, n, d]
    difference is materialised, and autograd saves it: at the flagship's
    148 rows of 2560-d frame features about 224 MB."""
    return (total[:, None, :] - total[None, :, :]).square().sum(dim=-1)


def gaussian_kernel(source: torch.Tensor, target: torch.Tensor,
                    kernel_mul: float = 2.0, kernel_num: int = 5,
                    fix_sigma: Optional[float] = None,
                    mask_source: Optional[torch.Tensor] = None,
                    mask_target: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Sum of ``kernel_num`` RBF kernels over the stacked [source; target]
    rows, bandwidths the mean pairwise squared distance over the
    off-diagonal pairs times powers of ``kernel_mul`` (reference
    loss.py:46-59; `ta3n_tpu/losses/losses.py::gaussian_kernel`).

    The bandwidth is detached, as the JAX ``stop_gradient``.  With row
    masks (both or neither) it is taken over the pairs of valid rows, and
    floored to 1 where at most one row is valid: a zero bandwidth would
    give NaN on the diagonal, which no later mask can weight out.  The
    kernel values of masked rows are still computed; the caller weights
    them out."""
    if (mask_source is None) != (mask_target is None):
        raise ValueError("mask_source and mask_target must be given "
                         "together (both or neither)")
    total = torch.cat([_as_2d(source), _as_2d(target)])
    n = total.shape[0]
    l2 = _pairwise_sq_dist(total)
    if fix_sigma is not None:
        bandwidth = torch.tensor(fix_sigma, dtype=total.dtype,
                                 device=total.device)
    elif mask_source is not None:
        m = torch.cat([mask_source, mask_target]).to(total.dtype)
        n_eff = m.sum()
        bandwidth = ((l2.detach() * (m[:, None] * m[None, :])).sum()
                     / (n_eff * n_eff - n_eff).clamp(min=1.0))
        bandwidth = torch.where(bandwidth > 0.0, bandwidth,
                                torch.ones_like(bandwidth))
    else:
        bandwidth = l2.detach().sum() / (n * n - n)
    bandwidth = bandwidth / (kernel_mul ** (kernel_num // 2))
    return sum(torch.exp(-l2 / (bandwidth * (kernel_mul ** i)))
               for i in range(kernel_num))


def _mmd_from_kernels(kernels: torch.Tensor, batch_size: int, ver: int,
                      mask_source: Optional[torch.Tensor] = None,
                      mask_target: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The MMD of a kernel matrix over [source; target]: ver 1, the
    reference's linear-time estimate; ver 2, the block means (the train
    loop's, main.py:496-500), over valid pairs only with masks."""
    if ver == 1:
        if mask_source is not None:
            raise ValueError("row masks are only supported for ver=2 "
                             "(the train loop's variant, main.py:496-500)")
        s1 = torch.arange(batch_size, device=kernels.device)
        s2 = (s1 + 1) % batch_size
        t1, t2 = s1 + batch_size, s2 + batch_size
        loss = (kernels[s1, s2].sum() + kernels[t1, t2].sum()
                - kernels[s1, t2].sum() - kernels[s2, t1].sum())
        return loss.abs() / batch_size
    if ver != 2:
        raise ValueError("ver == 1 or 2")
    xx = kernels[:batch_size, :batch_size]
    yy = kernels[batch_size:, batch_size:]
    xy = kernels[:batch_size, batch_size:]
    yx = kernels[batch_size:, :batch_size]
    if mask_source is None:
        return (xx + yy - xy - yx).mean()
    ms = mask_source.to(kernels.dtype)
    mt = mask_target.to(kernels.dtype)

    def bmean(block, wr, wc):
        w = wr[:, None] * wc[None, :]
        return (block * w).sum() / w.sum().clamp(min=1.0)

    return (bmean(xx, ms, ms) + bmean(yy, mt, mt)
            - bmean(xy, ms, mt) - bmean(yx, mt, ms))


def mmd_rbf(source: torch.Tensor, target: torch.Tensor,
            kernel_mul: float = 2.0, kernel_num: int = 5,
            fix_sigma: Optional[float] = None, ver: int = 2,
            mask_source: Optional[torch.Tensor] = None,
            mask_target: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RBF MMD, DAN's loss (reference loss.py:61-83, main.py:496-500);
    row masks (ver 2 only) keep padded rows out of the bandwidth and the
    block means."""
    kernels = gaussian_kernel(source, target, kernel_mul, kernel_num,
                              fix_sigma, mask_source, mask_target)
    return _mmd_from_kernels(kernels, source.shape[0], ver, mask_source,
                             mask_target)


def JAN(source_list: Sequence[torch.Tensor],
        target_list: Sequence[torch.Tensor],
        kernel_muls: Sequence[float] = (2.0, 2.0),
        kernel_nums: Sequence[int] = (2, 5),
        fix_sigma_list: Sequence[Optional[float]] = (None, None),
        ver: int = 2, mask_source: Optional[torch.Tensor] = None,
        mask_target: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Joint MMD: the MMD of the elementwise product of the layers'
    kernels (reference loss.py:85-120); row masks as in ``mmd_rbf``."""
    joint = None
    for src, tgt, mul, num, sigma in zip(source_list, target_list,
                                         kernel_muls, kernel_nums,
                                         fix_sigma_list):
        k = gaussian_kernel(src, tgt, mul, num, sigma, mask_source,
                            mask_target)
        joint = k if joint is None else joint * k
    return _mmd_from_kernels(joint, source_list[0].shape[0], ver,
                             mask_source, mask_target)


def loss_adaptive_weight(loss: torch.Tensor,
                         pred: torch.Tensor) -> torch.Tensor:
    """loss / log(var(pred)) + log(std(pred)), torch's unbiased var over
    every element (reference main.py:804-807, which its train loop does
    not call)."""
    flat = pred.reshape(-1)
    n = flat.shape[0]
    var = (flat - flat.mean()).square().mean() * n / max(n - 1, 1)
    return loss / torch.log(var) + torch.log(torch.sqrt(var))


def rand_select_batch(generator: torch.Generator, x: torch.Tensor,
                      num: int):
    """(indices, rows) of ``num`` rows of x drawn without replacement
    from ``generator``, a generator on x's device (reference
    randSelectBatch, utils/utils.py:8-11, which draws from the global
    RNG; the JAX function takes a key)."""
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=x.device)[:num]
    return idx, x[idx]


def CORAL(source: torch.Tensor, target: torch.Tensor,
          mask_source: Optional[torch.Tensor] = None,
          mask_target: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deep CORAL, ||C_s - C_t||_F^2 / (4 d^2) (Sun & Saenko 2016), which
    the reference calls (main.py:492-495) but never defines; with row
    masks the means and covariances run over the valid rows
    (`ta3n_tpu/losses/losses.py::CORAL`)."""
    source, target = _as_2d(source), _as_2d(target)
    d = source.shape[1]

    def cov(x, m):
        if m is None:
            n = torch.tensor(float(x.shape[0]), dtype=x.dtype,
                             device=x.device)
            xm = x - x.mean(dim=0, keepdim=True)
        else:
            w = m.to(x.dtype)[:, None]
            n = w.sum().clamp(min=1.0)
            xm = (x - (x * w).sum(dim=0, keepdim=True) / n) * w
        return (xm.T @ xm) / (n - 1).clamp(min=1.0)

    diff = cov(source, mask_source) - cov(target, mask_target)
    return (diff * diff).sum() / (4.0 * d * d)
