"""Plain torch version of the flash-attention kernel: the port of the JAX
package's oracle ``kernels/flash_attention/ref.py::attention_ref``.

Layout (B, H, S, hd), the kernel's.  GQA: KV heads broadcast by group.
Arithmetic as the oracle: q upcast to float32 then scaled, float32 scores
and probabilities, masked scores set to -1e30.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: float = 0.0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,hd); k/v: (B,KV,Skv,hd); KV divides H."""
    H, Sq, hd = q.shape[1], q.shape[2], q.shape[3]
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = s.masked_fill(~mask, -1e30)   # out of place: "dots" remat keeps s
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
