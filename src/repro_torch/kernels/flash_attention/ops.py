"""Device dispatch for the flash-attention kernel.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
build, launch or take the shapes) through :class:`KernelAttention`, which
gives it a gradient; a CPU tensor goes to the plain version under plain
autograd.  The choice follows the tensor's device and nothing else; the
JAX op's ``interpret=``, ``use_kernel=`` and block-size switches have no
counterpart.

The gradient on the card is the VJP of the plain version, recomputed from
the saved q, k and v in the backward pass: the JAX package has no backward
kernel, and its training forward differentiates its jnp attention, so this
is the gradient the reference trains with.  Two divergences follow: in
bfloat16 the forward kernel rounds P to bfloat16 before P·V and the
recomputed backward does not, so the gradient is that of a forward a
rounding away from the one the loss saw; and each backward costs one more
float32 attention forward (counted in ``RECOMPUTES``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .._build import count_launch
from . import flash_attention as _k
from .ref import attention_ref


class KernelAttention(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the VJP of
    :func:`~.ref.attention_ref` at the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        ctx.save_for_backward(q, k, v)
        return _k.flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad):
        count_launch(_k.RECOMPUTES, "flash_attention")
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = attention_ref(*inputs, **ctx.opts)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, need) if n], grad))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,KV,S,hd) → (B,H,S,hd) in q's dtype."""
    if q.device.type == "cuda":
        return KernelAttention.apply(q, k, v, causal, window, softcap, scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    raise ValueError(f"no flash-attention path for device {q.device}")
