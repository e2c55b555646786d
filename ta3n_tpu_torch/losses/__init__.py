from ta3n_tpu_torch.losses.losses import (CORAL, JAN, attentive_entropy,
                                          cross_entropy_soft, dis_MCD,
                                          entropy_from_logits,
                                          gaussian_kernel,
                                          loss_adaptive_weight, masked_mean,
                                          mmd_linear, mmd_rbf,
                                          rand_select_batch,
                                          weighted_cross_entropy)

__all__ = ["masked_mean", "entropy_from_logits", "weighted_cross_entropy",
           "cross_entropy_soft", "attentive_entropy", "dis_MCD",
           "mmd_linear", "gaussian_kernel", "mmd_rbf", "JAN", "CORAL",
           "loss_adaptive_weight", "rand_select_batch"]
