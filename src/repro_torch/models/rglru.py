"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the JAX package's ``models/rglru.py``.  Real-gated linear
recurrent unit:
    r_t = σ(W_r x_t);  i_t = σ(W_i x_t)
    a_t = a^{c·r_t}    (a = σ(Λ) learned, c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The recurrence over the full sequence is a log-depth scan in torch
elementwise ops (:func:`rglru_scan`); the reference's is
``jax.lax.associative_scan``, not a Pallas kernel, so there is no kernel
to port here.  Decode is one elementwise update of a (B, width) state.
The coefficients, the scan and the state update run in float32 (``lam``
stays float32 in bf16 params, as in the reference); the scan's output and
the carried state are cast back to the input's dtype, so a bf16 state is
rounded at every decode step, as the reference's is.

Block structure (Griffin): conv1d(width 4) → RG-LRU, gated by a parallel
GeLU branch (tanh approximation, ``jax.nn.gelu``'s default), then output
projection.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..pjit_utils import mesh_of
from .layers import Params, dense, dense_init, pad_zeros

RGLRU_C = 8.0


def rglru_init(gen: torch.Generator, d_model: int, *, width: int,
               conv_width: int, dtype, device=None) -> Params:
    # Λ init so that a = exp(-c·softplus(Λ)) ∈ (0.9, 0.999) at r=1
    u = 0.9 + 0.099 * torch.rand((width,), generator=gen, dtype=torch.float32,
                                 device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    conv_w = torch.randn((conv_width, width), generator=gen,
                         dtype=torch.float32, device=device) * 0.2
    return {
        "in_x": dense_init(gen, d_model, width, dtype, device=device),
        "in_gate": dense_init(gen, d_model, width, dtype, device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((width,), dtype=dtype, device=device),
        "w_r": dense_init(gen, width, width, dtype, device=device),
        "w_i": dense_init(gen, width, width, dtype, device=device),
        "lam": lam,
        "out": dense_init(gen, width, d_model, dtype, device=device),
    }


def _rglru_coeffs(p: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step (a_t, b_t) of the linear recurrence, in float32."""
    r = torch.sigmoid(dense(p["w_r"], x).float())
    i = torch.sigmoid(dense(p["w_i"], x).float())
    log_a = -RGLRU_C * r * F.softplus(p["lam"])        # log a_t  (≤ 0)
    a = torch.exp(log_a)
    gated = i * x.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * gated
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t with h_{-1} = 0, along axis 1, in
    ceil(log2 T) Hillis–Steele passes of the combine (a1, b1) ∘ (a2, b2) =
    (a1·a2, b1·a2 + b2): after the pass at offset d, step t holds the
    composition of steps (t-2d, t].  No cumulative product of ``a`` is
    formed (it would underflow over a long prompt and need a division).
    The combine is associative, but its order differs from XLA's tree for
    ``associative_scan``: results agree to rounding, not bit for bit.
    DTensors are scanned shard by shard (each (batch row, channel) is its
    own recurrence) unless their time axis is split."""
    mesh = mesh_of(b)
    if mesh is not None and not any(
            pl.is_shard() and pl.dim % b.dim() == 1 for pl in b.placements):
        from torch.distributed.tensor import DTensor
        a = a.redistribute(mesh, b.placements)
        return DTensor.from_local(_scan(a.to_local(), b.to_local()), mesh,
                                  b.placements, run_check=False)
    return _scan(a, b)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    T = a.shape[1]
    for k in range(math.ceil(math.log2(T)) if T > 1 else 0):
        d = 1 << k
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], b[:, :-d],
                                               a[:, d:])], dim=1)
        if 2 * d < T:                 # the last pass needs no new a
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
    return b


def rglru_scan(p: Params, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,T,W) → (y: (B,T,W), h_final: (B,W)), both in x's dtype.  On
    DTensors the coefficients are laid out as x (DTensor may have split
    their time axis for the gates' products), so the scan runs shard by
    shard."""
    a, b = _rglru_coeffs(p, x)
    if mesh_of(x) is not None:
        a, b = (t.redistribute(x.device_mesh, x.placements) for t in (a, b))
    if h0 is not None:
        # fold h0 in as a virtual step 0: b_0 = h0, a_0 = 1
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0.float()[:, None], b], dim=1)
    h = linear_scan(a, b)
    if h0 is not None:
        h = h[:, 1:]
    return h.to(x.dtype), h[:, -1].to(x.dtype)


def rglru_step(p: Params, x: torch.Tensor, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step: x (B,1,W), h (B,W) → (y (B,1,W) in x's dtype,
    the new state in h's dtype)."""
    a, b = _rglru_coeffs(p, x)
    new_h = a[:, 0] * h.float() + b[:, 0]
    return new_h.to(x.dtype)[:, None], new_h.to(h.dtype)


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   hist: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, x: (B,T,C), w: (W,C) → (out, the last W-1
    inputs, zero-padded on the left, for the next call's ``hist``).  A
    DTensor x whose time axis is whole is convolved shard by shard (each
    (batch row, channel) on its own), so its channel sharding reaches the
    scan."""
    mesh = mesh_of(x)
    if mesh is not None and hist is None and not any(
            pl.is_shard() and pl.dim % 3 == 1 for pl in x.placements):
        return _conv_local(mesh, x, w, b)
    W = w.shape[0]
    pads = (pad_zeros(x, (0, 0, W - 1, 0)) if hist is None
            else torch.cat([hist, x], dim=1))
    out = sum(pads[:, i:i + x.shape[1]] * w[i] for i in range(W))
    # a copy: a view would keep the whole padded input alive in the cache
    return out + b, pads[:, -(W - 1):].clone()


def _conv_local(mesh, x, w, b):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    chan = [pl.is_shard() and pl.dim % 3 == 2 for pl in x.placements]
    rows = [pl.is_shard() and pl.dim % 3 == 0 for pl in x.placements]

    def local(t, dim):
        # sharded as x's channels; the gradient partial over x's batch
        pl = [Shard(dim) if c else Replicate() for c in chan]
        grads = [Partial() if r else p for r, p in zip(rows, pl)]
        return t.redistribute(mesh, pl).to_local(grad_placements=grads)
    out, tail = _causal_conv1d(x.to_local(), local(w, 1), local(b, 0))
    return (DTensor.from_local(out, mesh, x.placements, run_check=False),
            DTensor.from_local(tail, mesh, x.placements, run_check=False))


def rglru_block(p: Params, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                return_final_state: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Griffin recurrent block.  x: (B,T,D).

    state = {"h": (B,W), "conv": (B,conv_width-1,W)} for decode (T = 1);
    ``return_final_state`` on the full sequence gives that state."""
    gate = F.gelu(dense(p["in_gate"], x), approximate="tanh")
    xr = dense(p["in_x"], x)
    if state is None:
        conv, tail = _causal_conv1d(xr, p["conv_w"], p["conv_b"])
        y, h_final = rglru_scan(p, conv)
        new_state = ({"h": h_final, "conv": tail.to(xr.dtype)}
                     if return_final_state else None)
    else:
        conv, tail = _causal_conv1d(xr, p["conv_w"], p["conv_b"],
                                    hist=state["conv"])
        y, h_final = rglru_step(p, conv, state["h"])
        new_state = {"h": h_final, "conv": tail.to(xr.dtype)}
    return dense(p["out"], y * gate), new_state


def rglru_state_shape(B: int, width: int, conv_width: int
                      ) -> Dict[str, Tuple[int, ...]]:
    return {"h": (B, width), "conv": (B, conv_width - 1, width)}
