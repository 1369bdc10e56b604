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
``einsum``s to XLA.  ``moe_ffn_shard_map`` (expert parallelism over a JAX
mesh with an explicit all-to-all) has no counterpart: one card holds every
expert (ROADMAP, "No equivalent").
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from .layers import _ACTIVATIONS, Params, dense, dense_init, ffn, ffn_init

_EXPERT_ACTIVATIONS = {k: _ACTIVATIONS[k] for k in ("silu", "gelu")}


def _expert_stack(gen: torch.Generator, shape, scale: float, dtype,
                  device) -> torch.Tensor:
    """(E, din, dout) weights drawn as float32 normals × ``scale`` one
    expert at a time, so the float32 transient is one expert's slice (a
    whole stack of llama4-maverick's would be 21.5 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device)
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
    counts = torch.bincount(expert, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(expert.numel(), device=expert.device)
    pos = torch.empty_like(expert)
    pos[order] = ranks - starts[expert[order]]
    return Routing(expert, pos, pos < C, gate, probs)


def moe_ffn(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, activation: str = "silu"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) → (B, S, D), plus the aux metrics
    ``load_balance_loss`` (Switch-style) and ``dropped_frac``."""
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
    ce = torch.bincount(r.expert, minlength=num_experts).float() / T
    aux = {"load_balance_loss": num_experts * torch.sum(me * ce) / top_k,
           "dropped_frac": 1.0 - r.keep.float().mean()}
    return y.reshape(B, S, D), aux
