"""PyTorch/CUDA port of the Lachesis reproduction.

Mirrors the JAX package's tree module for module; imports torch and numpy,
never JAX or the JAX package.  The public surface is :mod:`lachesis_torch`.
"""
