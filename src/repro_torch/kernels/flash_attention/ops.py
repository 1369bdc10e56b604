"""Device dispatch for the flash-attention kernels.

A CUDA tensor goes to the hand-written kernels (which raise if they cannot
build, launch or take the shapes) through :class:`KernelAttention`, which
gives the forward kernel its gradient; a CPU tensor goes to the plain
version under plain autograd, the gradient the reference trains with.  The
choice follows the tensor's device and nothing else; the JAX op's
``interpret=``, ``use_kernel=`` and block-size switches have no
counterpart.

The gradient on the card is the backward kernels' (``csrc/flash_attention_
bwd.cu``: in bf16 up to head dim 256 one fused wgmma/TMA kernel between a
D pass and a dq pass, else the FlashAttention-2 split): the forward saves
q, k, v, its output and each row's log-sum-exp, and the backward
recomputes P tile by tile from them, so no (Sq, Skv) score matrix is held
in either direction (the bf16 dq is summed in float32 scratch of
B·H·Sq·hd·4 bytes).
In bfloat16 the forward rounds P before P·V and the backward rounds P and
dS before their products, each within the bf16 limits the tests and
``chip_smoke.py`` phase 5 hold it to; in float32 both run in full float32.
A call without gradients (serving, under ``torch.no_grad``) takes the
forward alone and writes no log-sum-exp.

The kernels are reached through ``ctypes``, which no fake, meta or
``DTensor`` argument can pass, so each is a custom op: the forward
``repro_torch::flash_attention`` (:func:`flash_attention_op`), the forward
that also returns the log-sum-exp ``repro_torch::flash_attention_lse``
(:func:`flash_attention_lse_op`) and the backward
``repro_torch::flash_attention_backward`` (:func:`flash_attention_backward_op`).
Each op's CUDA implementation launches its kernel, its fake implementation
gives the outputs' shapes, dtypes and strides (the dry run's meta tensors
take it), and its ``DTensor`` sharding rule keeps batch-sharded or
head-sharded inputs as they are and gives the outputs their sharding;
DTensor redistributes other inputs to one of those first.  Head sharding
is offered only with more than one kv head, so a query head never lands
apart from its kv head.  On DTensors the backward runs shard by shard in
the layout the forward ran in (:mod:`.._spmd`).

Decode attention on the card, one query over a KV cache, is the decode
kernel's custom op ``repro_torch::flash_decode`` (:func:`flash_decode_op`,
:mod:`.flash_decode`), which ``models/layers._route`` calls where
``flash_decode.kernel_takes`` holds; it has no gradient and no sharding
rule, since DTensor callers hand it each rank's local tensors.

The kernels take the head dims in ``HEAD_DIMS`` (32, 64, 128, 256) and any
multiple of 32 above 256 (split into slices of those).  A CUDA or meta
tensor of another head dim (16 in every reduced config) goes through
:func:`pad_to_kernel`: q, k and v zero-padded on their last axis to
:func:`padded_head_dim`, the scale of the unpadded width passed, the
output sliced back.  Zero columns add nothing to q·k, and the padded
columns of P·V are dropped, so the values are the kernel's at the padded
width; the gradient flows through the pad and the slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ...pjit_utils import mesh_of
from .. import _spmd
from . import flash_attention as _k
from . import flash_decode as _d
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


@torch.library.custom_op("repro_torch::flash_attention_lse",
                         mutates_args=())
def flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool,
                           window: Optional[int], softcap: float,
                           scale: Optional[float]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward that also returns each row's log-sum-exp, float32
    (B, H, Sq): what :class:`KernelAttention` runs when a gradient is
    wanted."""
    return _k.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale, return_lse=True)


@flash_attention_lse_op.register_fake
def _flash_attention_lse_fake(q, k, v, causal, window, softcap, scale):
    B, H, Sq, hd = q.shape
    return (q.new_empty((B, Sq, H, hd)).transpose(1, 2),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=())
def flash_attention_backward_op(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, dout: torch.Tensor,
                                causal: bool, window: Optional[int],
                                softcap: float, scale: Optional[float]
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The backward kernel as a custom op: (dq, dk, dv) from the forward's
    inputs, output and log-sum-exp and the output's cotangent."""
    return _k.flash_attention_backward(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       softcap=softcap, scale=scale)


@flash_attention_backward_op.register_fake
def _flash_attention_backward_fake(q, k, v, out, lse, dout, causal, window,
                                   softcap, scale):
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    return (q.new_empty((B, Sq, H, hd)).transpose(1, 2),
            k.new_empty((B, Skv, KV, hd)).transpose(1, 2),
            v.new_empty((B, Skv, KV, hd)).transpose(1, 2))


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int], window: Optional[int],
                    softcap: float, q_offset: int, scale: Optional[float],
                    causal: bool) -> torch.Tensor:
    """The decode kernel as a custom op: q (B, 1, H, hd) over the cache k
    (B, Skv, KV, hd), v (B, Skv, KV, vd) → (B, 1, H, vd)."""
    return _d.flash_decode(q, k, v, kv_len=kv_len, window=window,
                           attn_softcap=softcap, q_offset=q_offset,
                           scale=scale, causal=causal)


@flash_decode_op.register_fake
def _flash_decode_fake(q, k, v, kv_len, window, softcap, q_offset, scale,
                       causal):
    B, _, H, _ = q.shape
    return q.new_empty((B, 1, H, v.shape[3]))


def _layouts(kv_heads: int):
    """The placements every flash op keeps on one mesh axis: replicated,
    batch-sharded, and (with more than one kv head) head-sharded (q on H,
    k and v on KV; the log-sum-exp on H)."""
    out = [Replicate(), Shard(0)]
    if kv_heads > 1:
        out.append(Shard(1))
    return out


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_attention_sharding(q, k, v, causal, window, softcap, scale):
    """(output, inputs) placements on one mesh axis."""
    rest = [None] * 4
    return [([p], [p] * 3 + rest) for p in _layouts(k.shape[1])]


@register_sharding(torch.ops.repro_torch.flash_attention_lse.default)
def _flash_attention_lse_sharding(q, k, v, causal, window, softcap, scale):
    rest = [None] * 4
    return [([p, p], [p] * 3 + rest) for p in _layouts(k.shape[1])]


@register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
def _flash_attention_backward_sharding(q, k, v, out, lse, dout, causal,
                                       window, softcap, scale):
    rest = [None] * 4
    return [([p] * 3, [p] * 6 + rest) for p in _layouts(k.shape[1])]


class KernelAttention(torch.autograd.Function):
    """Forward: the CUDA kernel, through :func:`flash_attention_lse_op`
    when a gradient is wanted (else :func:`flash_attention_op`, no
    log-sum-exp).  Backward: the backward kernel, through
    :func:`flash_attention_backward_op`, from the saved inputs, output and
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.opts = (causal, window, softcap, scale)
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_op(q, k, v, causal, window, softcap,
                                      scale)
        out, lse = flash_attention_lse_op(q, k, v, causal, window, softcap,
                                          scale)
        ctx.save_for_backward(q, k, v, out, lse)
        # on DTensors: the layout the sharding rule ran the kernel in
        ctx.mesh = mesh_of(out)
        ctx.layout = out.placements if ctx.mesh is not None else None
        return out

    @staticmethod
    def backward(ctx, grad):
        saved = list(ctx.saved_tensors)
        if ctx.mesh is not None:     # shard by shard, in the forward's layout
            saved = _spmd.to_locals(saved, ctx.mesh, [ctx.layout] * 5)
            grad = _spmd.to_locals([grad], ctx.mesh, [ctx.layout])[0]
        grads = list(flash_attention_backward_op(*saved, grad, *ctx.opts))
        grads = [g if n else None
                 for g, n in zip(grads, ctx.needs_input_grad[:3])]
        if ctx.mesh is not None:
            grads = _spmd.from_locals(grads, ctx.mesh, [ctx.layout] * 3)
        return (*grads, None, None, None, None)


def padded_head_dim(d: int) -> int:
    """The smallest head dim the kernels take that holds ``d``: the next
    built one up to 256, above it the next multiple of 32."""
    for hd in _k.HEAD_DIMS:
        if hd >= d:
            return hd
    return -(-d // 32) * 32


def pad_to_kernel(attend, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, causal: bool, window: Optional[int],
                  softcap: float, scale: Optional[float]) -> torch.Tensor:
    """``attend(q, k, v, causal, window, softcap, scale)`` (the kernel's
    :class:`KernelAttention`, or a stand-in) on q, k and v zero-padded
    from their head dim to :func:`padded_head_dim`'s, with the scale of
    the unpadded width; the output sliced back to it.  DTensors are padded
    by concatenation, so their batch and head sharding carries through."""
    hd = q.shape[-1]
    pad = (0, padded_head_dim(hd) - hd)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = attend(_spmd.pad_zeros(q, pad), _spmd.pad_zeros(k, pad),
                 _spmd.pad_zeros(v, pad), causal, window, softcap, scale)
    return out[..., :hd]


def kernel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, window: Optional[int], softcap: float,
                     scale: Optional[float]) -> torch.Tensor:
    """The kernel's route: :class:`KernelAttention` on a head dim the
    kernels take, through :func:`pad_to_kernel` on any other."""
    if _k.kernel_takes_head_dim(q.shape[-1]):
        return KernelAttention.apply(q, k, v, causal, window, softcap, scale)
    return pad_to_kernel(KernelAttention.apply, q, k, v, causal, window,
                         softcap, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,KV,S,hd) → (B,H,S,hd) in q's dtype.  CUDA
    and meta tensors take the kernels' custom ops (meta: their shapes
    only) through :func:`kernel_attention`; CPU tensors the plain
    version."""
    if q.device.type in ("cuda", "meta"):
        return kernel_attention(q, k, v, causal, window, softcap, scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    raise ValueError(f"no flash-attention path for device {q.device}")
