from ta3n_tpu_torch.losses.losses import entropy_from_logits

__all__ = ["entropy_from_logits"]
