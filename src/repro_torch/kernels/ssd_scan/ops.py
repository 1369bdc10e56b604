"""Device dispatch for the chunked SSD kernel.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
build, launch or take the shapes) through :class:`KernelSSD`, which gives
it a gradient; a CPU tensor goes to the plain version under plain
autograd.  The choice follows the tensor's device and nothing else.

The gradient on the card is the VJP of the plain version, recomputed from
the saved inputs in the backward pass: the JAX package has no backward
kernel and its training forward differentiates ``ssd_scan_ref``, so this
is the gradient the reference trains with.  In bfloat16 the forward kernel
rounds W, x⊙w and the state operand to bfloat16 and the recomputed
backward (float32 throughout) does not: the gradient is that of a forward
a rounding away from the one the loss saw.  Each backward costs one more
float32 scan (counted in ``RECOMPUTES``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .._build import count_launch
from . import ref as _ref
from . import ssd_scan as _k


class KernelSSD(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the VJP of
    :func:`~.ref.ssd_ref` at the saved inputs (y's and the final state's
    cotangents both)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _k.ssd_scan(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        count_launch(_k.RECOMPUTES, "ssd_scan")
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            y, state = _ref.ssd_ref(*inputs, ctx.chunk)
            grads = iter(torch.autograd.grad(
                (y, state), [t for t, n in zip(inputs, need) if n],
                (gy, gstate)))
        return (*(next(grads) if n else None for n in need), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,N); T a multiple of
    ``chunk`` → (y (B,T,H,P), final state (B,H,P,N)), both in x's dtype."""
    if x.device.type == "cuda":
        return KernelSSD.apply(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, A, Bm, Cm, chunk)
    raise ValueError(f"no SSD path for device {x.device}")
