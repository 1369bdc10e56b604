"""Plain torch version of the chunked SSD kernel: the port of the JAX
package's oracle ``models/ssd.py::ssd_scan_ref``, which the model's SSD
block (``models/ssd.py``) imports from here.

Arithmetic as the oracle: float32 throughout, the intra-chunk decay as
``exp`` of a pairwise segment sum masked to -inf above the diagonal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums: L[..., i, j] = Σ_{j<k≤i} log_a[k]."""
    T = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, the plain version of the SSD kernel and its oracle.
    x: (B,T,H,P); dt: (B,T,H); A: (H,) (negative); Bm/Cm: (B,T,N); T a
    multiple of ``chunk``.  Returns (y (B,T,H,P), final state (B,H,P,N)),
    both in x's dtype.  One chunk's (H, L, L) decay tile is live at a time."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    h = (init_state.float() if init_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                          device=x.device))
    ys = []
    for c0 in range(0, T, chunk):
        xi = x[:, c0:c0 + chunk].float()                         # (B,L,H,P)
        dti = dt[:, c0:c0 + chunk].float()                       # (B,L,H)
        bi = Bm[:, c0:c0 + chunk].float()                        # (B,L,N)
        ci = Cm[:, c0:c0 + chunk].float()
        dA = dti * A
        cs = torch.cumsum(dA, dim=1)
        # intra-chunk quadratic form
        Lm = torch.exp(_segsum(dA.transpose(1, 2)))              # (B,H,L,L)
        scores = torch.einsum("bln,bmn->blm", ci, bi)
        y = torch.einsum("blm,bhlm,bmh,bmhp->blhp", scores, Lm, dti, xi)
        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bln,blh,bhpn->blhp", ci, torch.exp(cs), h)
        # state update
        decay_states = torch.exp(cs[:, -1:, :] - cs) * dti        # (B,L,H)
        upd = torch.einsum("bln,blh,blhp->bhpn", bi, decay_states, xi)
        h = h * torch.exp(cs[:, -1])[..., None, None] + upd
        ys.append(y.to(x.dtype))
    y = (torch.cat(ys, dim=1) if ys
         else torch.empty((Bsz, 0, H, P), dtype=x.dtype, device=x.device))
    return y, h.to(x.dtype)
