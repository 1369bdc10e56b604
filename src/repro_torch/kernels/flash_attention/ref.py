"""Plain torch versions of the flash-attention kernels: the port of the JAX
package's oracle ``kernels/flash_attention/ref.py::attention_ref``, the
forward with its row log-sum-exp, and the backward by the formulas the
backward kernel computes.

Layout (B, H, S, hd), the kernels'.  GQA: KV heads broadcast by group.
Arithmetic as the oracle: q upcast to float32 then scaled, float32 scores
and probabilities, masked scores set to -1e30.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], softcap: float, scale: Optional[float],
            slope: bool = False):
    """(scaled, softcapped scores with masked entries at -1e30, the mask,
    with ``slope`` the softcap's 1 - tanh^2 (else None), the scale),
    float32."""
    Sq, hd = q.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    Skv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
    dcap = None
    if softcap > 0:
        th = torch.tanh(s / softcap)
        s = th * softcap
        if slope:
            dcap = 1 - th * th
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = s.masked_fill(~mask, -1e30)   # out of place: "dots" remat keeps s
    return s, mask, dcap, scale


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,hd); k/v: (B,KV,Skv,hd); KV divides H."""
    G = q.shape[1] // k.shape[1]
    s, _, _, _ = _scores(q, k, causal, window, softcap, scale)
    p = torch.softmax(s, dim=-1)
    vf = v.float().repeat_interleave(G, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: float = 0.0, scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_ref` and each row's log-sum-exp (natural log) of
    its scaled, softcapped, masked scores: float32 (B, H, Sq), what the
    forward kernel saves for the backward."""
    s, _, _, _ = _scores(q, k, causal, window, softcap, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    vf = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype), lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None, softcap: float = 0.0,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` at q, k, v for the output's
    cotangent ``dout``, by the backward kernel's formulas in float32 (not
    autograd): P = exp(S - lse) (0 where masked), dv = P^T dout,
    dP = dout v^T, D = rowsum(dout * out), dS = P (dP - D) (times
    1 - tanh^2 under a softcap), dq = dS k scale, dk = dS^T q scale; dk
    and dv summed over each kv head's group.  ``out`` and ``lse`` are the
    forward's.  Each in its input's dtype."""
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    s, mask, dcap, scale = _scores(q, k, causal, window, softcap, scale,
                                   slope=True)
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~mask, 0.0)
    dof = dout.float()
    vf = v.float().repeat_interleave(G, dim=1)
    kf = k.float().repeat_interleave(G, dim=1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale

    def by_group(t):
        return t.reshape(B, KV, G, Skv, hd).sum(2)
    return (dq.to(q.dtype), by_group(dk).to(k.dtype),
            by_group(dv).to(v.dtype))
