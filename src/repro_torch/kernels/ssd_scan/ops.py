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

As for flash attention, the forward is a custom op,
``repro_torch::ssd_scan`` (:func:`ssd_scan_op`): CUDA tensors launch the
kernel, fake and meta tensors get the outputs' shapes, and its
``DTensor`` sharding rule keeps batch-sharded inputs (A replicated) or
head-sharded ones (x and dt on H, A on its one dim, B and C replicated)
and gives y and the state the same sharding.  On DTensors the backward
runs the twin's VJP shard by shard in the layout the kernel ran in
(:mod:`.._spmd`).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ...pjit_utils import mesh_of
from .. import _spmd
from .._build import count_launch
from . import ref as _ref
from . import ssd_scan as _k


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's forward as a custom op: the launcher, which takes CUDA
    tensors only (the dispatcher below sends CPU tensors to the plain
    version before they reach it)."""
    return _k.ssd_scan(x, dt, A, Bm, Cm, chunk)


@ssd_scan_op.register_fake
def _ssd_scan_fake(x, dt, A, Bm, Cm, chunk):
    B, T, H, P = x.shape
    return x.new_empty((B, T, H, P)), x.new_empty((B, H, P, Bm.shape[-1]))


@register_sharding(torch.ops.repro_torch.ssd_scan.default)
def _ssd_scan_sharding(x, dt, A, Bm, Cm, chunk):
    """((y, state), inputs) placements on one mesh axis: replicated,
    batch-sharded, or head-sharded."""
    R = Replicate()
    return [([R, R], [R] * 5 + [None]),
            ([Shard(0), Shard(0)],
             [Shard(0), Shard(0), R, Shard(0), Shard(0), None]),
            ([Shard(2), Shard(1)],
             [Shard(2), Shard(2), Shard(0), R, R, None])]


class KernelSSD(torch.autograd.Function):
    """Forward: the CUDA kernel, through :func:`ssd_scan_op`.  Backward:
    the VJP of :func:`~.ref.ssd_ref` at the saved inputs (y's and the
    final state's cotangents both)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        y, state = ssd_scan_op(x, dt, A, Bm, Cm, chunk)
        # on DTensors: the layouts the sharding rule ran the kernel in
        ctx.mesh = mesh_of(y)
        if ctx.mesh is not None:
            ctx.out_layout = [y.placements, state.placements]
            ctx.in_layout = _input_layout(y.placements)
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        count_launch(_k.RECOMPUTES, "ssd_scan")
        need = ctx.needs_input_grad[:5]
        saved = list(ctx.saved_tensors)
        if ctx.mesh is not None:     # shard by shard, in the forward's layout
            saved = _spmd.to_locals(saved, ctx.mesh, ctx.in_layout)
            x, Bm = saved[0], saved[3]
            local = [x.shape, (x.shape[0], x.shape[2], x.shape[3],
                               Bm.shape[-1])]
            # an unused output's cotangent arrives as plain zeros
            gy, gstate = [
                _spmd.to_locals([g], ctx.mesh, [pl])[0]
                if mesh_of(g) is not None else g.new_zeros(shape)
                for g, pl, shape in zip((gy, gstate), ctx.out_layout,
                                        local)]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            y, state = _ref.ssd_ref(*inputs, ctx.chunk)
            grads = iter(torch.autograd.grad(
                (y, state), [t for t, n in zip(inputs, need) if n],
                (gy, gstate)))
            grads = [next(grads) if n else None for n in need]
        if ctx.mesh is not None:
            grads = _spmd.from_locals(
                grads, ctx.mesh, _spmd.partial_where_replicated(
                    ctx.in_layout, ctx.out_layout[0]))
        return (*grads, None)


def _input_layout(y_layout) -> list:
    """(x, dt, A, B, C) placements for the layout y came out in, per mesh
    axis: the rule's batch-sharded, head-sharded or replicated inputs."""
    R = Replicate()
    per_axis = []
    for p in y_layout:
        if p == Shard(0):
            per_axis.append([Shard(0), Shard(0), R, Shard(0), Shard(0)])
        elif p == Shard(2):
            per_axis.append([Shard(2), Shard(2), Shard(0), R, R])
        else:
            per_axis.append([R] * 5)
    return [list(pl) for pl in zip(*per_axis)]


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,N); T a multiple of
    ``chunk`` → (y (B,T,H,P), final state (B,H,P,N)), both in x's dtype.
    CUDA and meta tensors take the kernel's custom op (meta: its shapes
    only), CPU tensors the plain version."""
    if x.device.type in ("cuda", "meta"):
        return KernelSSD.apply(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, A, Bm, Cm, chunk)
    raise ValueError(f"no SSD path for device {x.device}")
