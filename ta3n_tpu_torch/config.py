"""Model configuration: the JAX package's `ModelConfig`, which imports no
jax, re-exported so that the port's callers import from the port."""

from ta3n_tpu.config import ModelConfig

__all__ = ["ModelConfig"]
