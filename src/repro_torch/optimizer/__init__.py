"""AdamW, LR schedules and gradient compression over trees of tensors: the
port of the JAX package's ``optimizer/``."""
