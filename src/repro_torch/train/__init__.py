"""Training: the synthetic data pipeline, the optimizers, the microbatched
train step and checkpoints committed through the coordinator, ported from
the JAX package's ``train``."""
