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

The kernel is reached through ``ctypes``, which no fake, meta or
``DTensor`` argument can pass, so its forward is the custom op
``repro_torch::flash_attention`` (:func:`flash_attention_op`): its CUDA
implementation launches the kernel, its fake implementation gives the
output's shape, dtype and strides (the dry run's meta tensors take it),
and its ``DTensor`` sharding rule keeps batch-sharded or head-sharded
inputs as they are and gives the output their sharding; DTensor
redistributes other inputs to one of those first.  Head sharding is
offered only with more than one kv head, so a query head never lands
apart from its kv head.  On DTensors the backward runs the twin's VJP
shard by shard in the layout the kernel ran in (:mod:`.._spmd`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ...pjit_utils import mesh_of
from .. import _spmd
from .._build import count_launch
from . import flash_attention as _k
from .ref import attention_ref


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int], softcap: float,
                       scale: Optional[float]) -> torch.Tensor:
    """The kernel's forward as a custom op: the launcher, which takes CUDA
    tensors only (the dispatcher below sends CPU tensors to the plain
    version before they reach it)."""
    return _k.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap, scale):
    B, H, Sq, hd = q.shape
    return q.new_empty((B, Sq, H, hd)).transpose(1, 2)


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_attention_sharding(q, k, v, causal, window, softcap, scale):
    """(output, inputs) placements on one mesh axis: replicated, batch-
    sharded, or head-sharded (q on H, k and v on KV)."""
    rest = [None] * 4
    rules = [([Replicate()], [Replicate()] * 3 + rest),
             ([Shard(0)], [Shard(0)] * 3 + rest)]
    if k.shape[1] > 1:
        rules.append(([Shard(1)], [Shard(1)] * 3 + rest))
    return rules


class KernelAttention(torch.autograd.Function):
    """Forward: the CUDA kernel, through :func:`flash_attention_op`.
    Backward: the VJP of :func:`~.ref.attention_ref` at the saved
    inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        ctx.save_for_backward(q, k, v)
        out = flash_attention_op(q, k, v, causal, window, softcap, scale)
        # on DTensors: the layout the sharding rule ran the kernel in
        ctx.mesh = mesh_of(out)
        ctx.layout = out.placements if ctx.mesh is not None else None
        return out

    @staticmethod
    def backward(ctx, grad):
        count_launch(_k.RECOMPUTES, "flash_attention")
        need = ctx.needs_input_grad[:3]
        saved = list(ctx.saved_tensors)
        if ctx.mesh is not None:     # shard by shard, in the forward's layout
            saved = _spmd.to_locals(saved, ctx.mesh, [ctx.layout] * 3)
            grad = _spmd.to_locals([grad], ctx.mesh, [ctx.layout])[0]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = attention_ref(*inputs, **ctx.opts)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, need) if n], grad))
            grads = [next(grads) if n else None for n in need]
        if ctx.mesh is not None:
            grads = _spmd.from_locals(grads, ctx.mesh, [ctx.layout] * 3)
        return (*grads, None, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,KV,S,hd) → (B,H,S,hd) in q's dtype.  CUDA
    and meta tensors take the kernel's custom op (meta: its shapes only),
    CPU tensors the plain version."""
    if q.device.type in ("cuda", "meta"):
        return KernelAttention.apply(q, k, v, causal, window, softcap, scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    raise ValueError(f"no flash-attention path for device {q.device}")
