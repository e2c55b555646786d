from ta3n_tpu_torch.losses.losses import (attentive_entropy,
                                          cross_entropy_soft, dis_MCD,
                                          entropy_from_logits, masked_mean,
                                          weighted_cross_entropy)

__all__ = ["masked_mean", "entropy_from_logits", "weighted_cross_entropy",
           "cross_entropy_soft", "attentive_entropy", "dis_MCD"]
