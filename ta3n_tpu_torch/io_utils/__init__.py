"""Weight conversion between the JAX package, reference-format `.pth.tar`
checkpoints and the port's modules."""
