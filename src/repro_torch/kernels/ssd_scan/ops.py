"""Device dispatch for the chunked SSD kernels.

A CUDA tensor goes to the hand-written kernels (which raise if they cannot
build, launch or take the shapes) through :class:`KernelSSD`, which gives
the forward kernel its gradient; a CPU tensor goes to the plain version
under plain autograd.  The choice follows the tensor's device and nothing
else.

The gradient on the card is the backward kernel's
(``csrc/ssd_scan_bwd.cu``): from the saved inputs and both outputs'
cotangents it recomputes the states entering each chunk, carries the
state's cotangent back, and computes dx, ddt, dA, dB and dC chunk by chunk,
holding no (L, L) decay block in device memory.  The JAX package has no
backward kernel and its training forward differentiates ``ssd_scan_ref``;
the kernel computes that gradient.  In bfloat16 the forward rounds W, x·w
and the state operand to bfloat16 and the backward rounds gy·exp(cs), the
carried states and the decay-weighted tiles before their products (x·w
it takes as two bf16 parts), each within the bf16 limits the tests and
``chip_smoke.py`` phase 6 hold it to; in float32 both run in full
float32.

As for flash attention, each kernel is a custom op: the forward
``repro_torch::ssd_scan`` (:func:`ssd_scan_op`) and the backward
``repro_torch::ssd_scan_backward`` (:func:`ssd_scan_backward_op`).  CUDA
tensors launch the kernel, fake and meta tensors get the outputs' shapes,
and the forward's ``DTensor`` sharding rule keeps batch-sharded inputs (A
replicated) or head-sharded ones (x and dt on H, A on its one dim, B and C
replicated) and gives y and the state the same sharding.  On DTensors the
backward runs the backward op shard by shard in the layout the forward
ran in (:mod:`.._spmd`), the gradients of replicated inputs partial over
the axes that split the work (dA on batch-sharded layouts, dB and dC on
head-sharded ones).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ...pjit_utils import mesh_of
from .. import _spmd
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


@torch.library.custom_op("repro_torch::ssd_scan_backward", mutates_args=())
def ssd_scan_backward_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, Cm: torch.Tensor,
                         gy: torch.Tensor, gstate: torch.Tensor, chunk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """The backward kernel as a custom op: (dx, ddt, dA, dB, dC) from the
    forward's inputs and the cotangents of y and the final state."""
    return _k.ssd_scan_backward(x, dt, A, Bm, Cm, gy, gstate, chunk)


@ssd_scan_backward_op.register_fake
def _ssd_scan_backward_fake(x, dt, A, Bm, Cm, gy, gstate, chunk):
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    return (x.new_empty((B, T, H, P)), dt.new_empty((B, T, H), dtype=f32),
            A.new_empty((H,), dtype=f32), x.new_empty((B, T, N)),
            x.new_empty((B, T, N)))


class KernelSSD(torch.autograd.Function):
    """Forward: the CUDA kernel, through :func:`ssd_scan_op`.  Backward:
    the backward kernel, through :func:`ssd_scan_backward_op`, from the
    saved inputs and y's and the final state's cotangents."""

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
        grads = ssd_scan_backward_op(*saved, gy, gstate, ctx.chunk)
        grads = [g if n else None
                 for g, n in zip(grads, ctx.needs_input_grad[:5])]
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
