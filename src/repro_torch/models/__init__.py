"""LM stack of the torch port: layers, SSD, the config-driven transformer
and the weight carrier from the JAX package."""
