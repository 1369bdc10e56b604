"""Device dispatch for the chunked SSD kernel.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
build, launch or take the shapes); a CPU tensor goes to the plain version.
The choice follows the tensor's device and nothing else.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import ssd_scan as _k
from . import ref as _ref


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,N); T a multiple of
    ``chunk`` → (y (B,T,H,P), final state (B,H,P,N)), both in x's dtype."""
    if x.device.type == "cuda":
        return _k.ssd_scan(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return _ref.ssd_ref(x, dt, A, Bm, Cm, chunk)
    raise ValueError(f"no SSD path for device {x.device}")
