"""Mixture-of-Experts layer with capacity-bucketed dispatch.

The port of the JAX package's ``models/moe.py`` (its single-device scatter
formulation).  The Lachesis connection (DESIGN §4): token→expert dispatch
is hash partitioning by a learned key — the router is the partitioner
candidate, each expert's (C, D) queue a worker's padded bucket.  Tokens
are scattered into an (E, C, D) buffer, each expert runs its FFN as one
batched matmul, and the rows are gathered back weighted by their gates.

Routing equals the reference's exactly: the top-k experts of the softmax
probabilities with ties to the lower index (``jax.lax.top_k``'s rule; a
stable descending sort here, since ``torch.topk`` promises no order among
ties), each (token, slot)'s position in its expert's queue counted in the
flattened (token, slot) order, and rows at or past the capacity dropped.
The dispatch is ``index_put(..., accumulate=True)``: a dropped row is
zeroed and lands on slot C-1, where it adds exactly nothing, so the buffer
holds the same values in any summation order.

The expert products are plain batched matmuls, as the reference leaves its
``einsum``s to XLA.  Expert counts are a scatter-add, not ``bincount``,
whose output length depends on the values (the dry run's meta tensors
have none).

Under SPMD (:func:`..pjit_utils.spmd_enabled`, a ``DTensor`` input) the
layer is :func:`moe_ffn_shard_map`: expert parallelism over the
``DeviceMesh``'s "model" axis with one explicit all-to-all each way, the
counterpart of the reference's ``shard_map``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..core.sharding_bridge import P
from ..pjit_utils import constrain, mesh_of, spmd_enabled
from .layers import _ACTIVATIONS, Params, dense, dense_init, ffn, ffn_init

_EXPERT_ACTIVATIONS = {k: _ACTIVATIONS[k] for k in ("silu", "gelu")}


def _expert_stack(gen: torch.Generator, shape, scale: float, dtype,
                  device) -> torch.Tensor:
    """(E, din, dout) weights drawn as float32 normals × ``scale`` one
    expert at a time, so the float32 transient is one expert's slice (a
    whole stack of llama4-maverick's would be 21.5 GB).  On the meta device
    (the dry run's shapes, no values) the stack is allocated as it is."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for e in range(shape[0]):
        out[e] = (torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                              device=device) * scale).to(dtype)
    return out


def moe_init(gen: torch.Generator, d_model: int, d_ff_expert: int,
             num_experts: int, num_shared: int, dtype,
             device=None) -> Params:
    """The reference's leaves, shapes and scales; the router stays float32
    in any model dtype."""
    E, D, F = num_experts, d_model, d_ff_expert
    p = {
        "router": dense_init(gen, D, E, torch.float32, device=device),
        "w_in": _expert_stack(gen, (E, D, F), 1.0 / math.sqrt(D), dtype,
                              device),
        "w_gate": _expert_stack(gen, (E, D, F), 1.0 / math.sqrt(D), dtype,
                                device),
        "w_out": _expert_stack(gen, (E, F, D), 1.0 / math.sqrt(F), dtype,
                               device),
    }
    if num_shared > 0:
        p["shared"] = ffn_init(gen, D, F * num_shared, dtype, device=device)
    return p


def capacity(tokens: int, num_experts: int, top_k: int,
             factor: float = 1.25) -> int:
    c = int(math.ceil(tokens * top_k / num_experts * factor))
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference


class Routing(NamedTuple):
    """Where each (token, slot) goes, flattened in (token, slot) order."""
    expert: torch.Tensor      # (T*k,) int64 expert index
    pos: torch.Tensor         # (T*k,) int64 position in its expert's queue
    keep: torch.Tensor        # (T*k,) bool: pos < C
    gate: torch.Tensor        # (T, k) float32 renormalised gate values
    probs: torch.Tensor       # (T, E) float32 router probabilities


def expert_counts(expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """How many (token, slot)s chose each expert: (E,) int64."""
    return torch.zeros(num_experts, dtype=torch.int64,
                       device=expert.device).index_add_(
        0, expert, torch.ones_like(expert))


def route(p: Params, xt: torch.Tensor, num_experts: int, top_k: int,
          C: int) -> Routing:
    """Router, top-k and queue positions of tokens ``xt`` (T, D)."""
    logits = dense(p["router"], xt.float())                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # descending and stable: ties keep the lower expert index first
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = srt.values[:, :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    expert = srt.indices[:, :top_k].reshape(-1)                 # (T*k,)
    # position = how many earlier (token, slot)s chose the same expert: a
    # stable sort by expert keeps the flattened order within each queue
    order = torch.argsort(expert, stable=True)
    counts = expert_counts(expert, num_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(expert.numel(), device=expert.device)
    pos = torch.empty_like(expert)
    pos[order] = ranks - starts[expert[order]]
    return Routing(expert, pos, pos < C, gate, probs)


def moe_ffn(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, activation: str = "silu"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → (B, S, D), plus the aux metrics
    ``load_balance_loss`` (Switch-style) and ``dropped_frac``.  Under SPMD
    with a ``DTensor`` input this is :func:`moe_ffn_shard_map`."""
    if spmd_enabled() and mesh_of(x) is not None:
        return moe_ffn_shard_map(p, x, num_experts=num_experts, top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 activation=activation)
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    C = capacity(T, num_experts, top_k, capacity_factor)
    r = route(p, xt, num_experts, top_k, C)

    # dispatch: scatter token rows into (E, C, D); dropped rows are zeroed
    # and all land on slot C-1
    slot = torch.where(r.keep, r.pos, C - 1)
    src = xt.repeat_interleave(top_k, dim=0) * r.keep[:, None].to(x.dtype)
    buf = x.new_zeros((num_experts, C, D)).index_put(
        (r.expert, slot), src, accumulate=True)
    del src
    # expert-parallel placement: the exchange this asks for IS the shuffle
    # Lachesis reasons about (DESIGN §4)
    buf = constrain(buf, P("model", None, None))

    # grouped expert FFN: (E, C, D) @ (E, D, F)
    act = _EXPERT_ACTIVATIONS[activation]
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_in"])
    del buf
    out_buf = torch.bmm(h, p["w_out"])                           # (E, C, D)
    del h

    # combine: gather back and weight by gate
    w = (r.gate.reshape(-1) * r.keep).to(x.dtype)
    y = (out_buf[r.expert, slot] * w[:, None]).reshape(T, top_k, D).sum(1)

    if "shared" in p:
        y = y + ffn(p["shared"], xt, activation)

    me = r.probs.mean(dim=0)                                     # (E,)
    ce = expert_counts(r.expert, num_experts).float() / T
    aux = {"load_balance_loss": num_experts * torch.sum(me * ce) / top_k,
           "dropped_frac": 1.0 - r.keep.float().mean()}
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Expert parallelism: local dispatch + explicit all-to-all over "model"
# ---------------------------------------------------------------------------

def _waited(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


class _SumOver(torch.autograd.Function):
    """All-reduce sum over ``group`` of a partial result whose consumer is
    replicated over it: the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        return _waited(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _MeanOver(torch.autograd.Function):
    """All-reduce mean over ``group`` (of ``n`` ranks) of a value whose
    consumer is replicated over it: each rank's share of the gradient is
    1/n of it, and the partial parameter gradients are summed by DTensor."""

    @staticmethod
    def forward(ctx, t, group, n):
        from torch.distributed import _functional_collectives as funcol
        ctx.n = n
        return _waited(funcol.all_reduce(t, "avg", group))

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None, None


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of ``t``'s dim 0 to rank j; the result stacks the chunks
    received in rank order along dim 0 (differentiable: the backward is
    the reverse exchange)."""
    from torch.distributed import _functional_collectives as funcol
    return _waited(funcol.all_to_all_single_autograd(
        t.contiguous(), None, None, group))


def moe_ffn_shard_map(p: Params, x, *, num_experts: int, top_k: int,
                      capacity_factor: float, activation: str
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE on ``x``'s ``DeviceMesh`` (the reference's
    ``shard_map`` version): experts live on the "model" axis and tokens
    stay batch-sharded over the data axes; when "model" divides the
    sequence, tokens are sequence-sharded over it too, so every rank
    dispatches distinct tokens.  Each rank routes its own tokens with a
    local capacity, and the (E, C, D) buffer goes to the experts' ranks in
    one all-to-all and comes back in another (each one more in the
    backward).  The shared expert runs d_ff-sliced over "model" with a sum
    over it, or unsharded on the local slice when the sequence is sharded.
    The aux losses are averaged over the data axes (and "model" when the
    sequence is sharded).  ``p``'s leaves and ``x`` are DTensors;
    the output is laid out as the tokens were dispatched, the aux metrics
    replicated."""
    import math as _math

    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..launch.shardings import to_placements

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    mp = sizes.get("model", 1)
    dp_axes = tuple(a for a in names if a != "model")
    dp_spec = (dp_axes if len(dp_axes) != 1 else dp_axes[0]) \
        if dp_axes else None
    E = num_experts
    act = _EXPERT_ACTIVATIONS[activation]

    # sequence-sharded dispatch: without it the replicated-x dispatch does
    # mp× redundant expert compute
    seq_shard = mp > 1 and x.shape[1] % mp == 0
    # decode (B=1 or tiny): batch may not divide the DP axes — replicate
    dp_size = _math.prod(sizes[a] for a in dp_axes) if dp_axes else 1
    if x.shape[0] % max(dp_size, 1) != 0:
        dp_spec = None
    x_spec = (P(dp_spec, "model", None) if seq_shard
              else P(dp_spec, None, None))
    token_axes = {a for e in x_spec if e is not None
                  for a in (e if isinstance(e, tuple) else (e,))}

    def local(t, spec):
        """``t`` laid out as ``spec``, its local shard; its gradient is
        partial over the mesh axes the tokens are split on."""
        placements = to_placements(mesh, spec)
        grads = [Partial() if n in token_axes and pl == Replicate() else pl
                 for n, pl in zip(names, placements)]
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grads)

    rep = lambda nd: P(*([None] * nd))                  # noqa: E731
    router = {k: local(v, rep(v.dim())) for k, v in p["router"].items()}
    experts = {k: local(p[k], P("model", None, None))
               for k in ("w_in", "w_gate", "w_out")}
    shared = None
    if "shared" in p:
        # TP layout for the shared expert: d_ff sliced over "model"; with
        # the sequence sharded its psum would double-count, so unsharded
        tp = {"w_in": P(None, "model"), "w_gate": P(None, "model"),
              "w_out": P("model", None)}
        shared = {k: {"w": local(v["w"], rep(2) if seq_shard else tp[k])}
                  for k, v in p["shared"].items()}
    xl = local(x, x_spec)

    group = mesh.get_group("model") if mp > 1 else None
    B_loc, S, D = xl.shape
    T = B_loc * S
    xt = xl.reshape(T, D)
    C = capacity(T, E, top_k, capacity_factor)
    r = route({"router": router}, xt, E, top_k, C)
    slot = torch.where(r.keep, r.pos, C - 1)
    src = xt.repeat_interleave(top_k, dim=0) * r.keep[:, None].to(xl.dtype)
    buf = xl.new_zeros((E, C, D)).index_put((r.expert, slot), src,
                                            accumulate=True)
    if mp > 1:
        # (E, C, D) → (E_loc, mp·C, D): rank j's queue for my experts
        buf = _all_to_all(buf, group)
        buf = buf.reshape(mp, E // mp, C, D).transpose(0, 1).reshape(
            E // mp, mp * C, D)
    h = act(torch.bmm(buf, experts["w_gate"])) * torch.bmm(
        buf, experts["w_in"])
    out_buf = torch.bmm(h, experts["w_out"])
    if mp > 1:
        # (E_loc, mp·C, D) → (E, C, D): my tokens' rows from every expert
        out_buf = out_buf.reshape(E // mp, mp, C, D).transpose(0, 1)
        out_buf = _all_to_all(out_buf.reshape(E, C, D), group)
    w = (r.gate.reshape(-1) * r.keep).to(xl.dtype)
    y = (out_buf[r.expert, slot] * w[:, None]).reshape(T, top_k, D).sum(1)
    if shared is not None:
        y_sh = ffn(shared, xt, activation)
        y = y + (y_sh if seq_shard or mp == 1
                 else _SumOver.apply(y_sh, group))

    me = r.probs.mean(dim=0)
    ce = expert_counts(r.expert, E).float() / T
    aux = torch.stack([E * torch.sum(me * ce) / top_k,
                       1.0 - r.keep.float().mean()])
    for a in dp_axes + (("model",) if seq_shard else ()):
        if sizes[a] > 1:
            aux = _MeanOver.apply(aux, mesh.get_group(a), sizes[a])

    y = DTensor.from_local(y.reshape(B_loc, S, D), mesh,
                           to_placements(mesh, x_spec), run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate()] * len(names),
                             run_check=False)
    return y, {"load_balance_loss": aux[0], "dropped_frac": aux[1]}
