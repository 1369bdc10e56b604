"""Device dispatch for the flash-attention kernel.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
build, launch or take the shapes); a CPU tensor goes to the plain version.
The choice follows the tensor's device and nothing else; the JAX op's
``interpret=``, ``use_kernel=`` and block-size switches have no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _k
from .ref import attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,S,hd); k/v: (B,KV,S,hd) → (B,H,S,hd) in q's dtype."""
    if q.device.type == "cuda":
        return _k.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    raise ValueError(f"no flash-attention path for device {q.device}")
