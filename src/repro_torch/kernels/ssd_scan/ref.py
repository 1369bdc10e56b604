"""Plain torch version of the chunked SSD kernel: the port of the JAX
package's oracle ``models/ssd.py::ssd_scan_ref``, which the model's SSD
block (``models/ssd.py``) imports from here.

Arithmetic as the oracle: float32 throughout, the intra-chunk decay as
``exp`` of a pairwise segment sum masked to -inf above the diagonal;
blocks of chunks at a time (see :func:`ssd_ref`).
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


#: elements of the (B, chunks, H, L, L) decay tile processed at once:
#: 2^27 floats (512 MB); mamba2-370m's batch 8 × 2048 fits in one block
BLOCK_ELEMS = 1 << 27


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD, the plain version of the SSD kernel and its oracle.
    x: (B,T,H,P); dt: (B,T,H); A: (H,) (negative); Bm/Cm: (B,T,N); T a
    multiple of ``chunk``.  Returns (y (B,T,H,P), final state (B,H,P,N)),
    both in x's dtype.

    The reference's per-chunk terms, computed for a block of chunks at a
    time with batched matmuls (a block's decay tiles stay under
    :data:`BLOCK_ELEMS`): the intra-chunk form W·x with W = (C·Bᵀ) ⊙
    exp(segsum(dt·A)) ⊙ dt, each chunk's zero-initial state Σ B ⊗
    (exp(cs_last − cs)·dt·x), then the states carried across the chunks
    in order and read back through C with exp(cs).  The same sums as the
    reference's einsums in another order (float32 rounding apart), in a
    few large launches: on the card a training step's backward takes
    this function's VJP (``ops.KernelSSD``)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk
    h = (init_state.float() if init_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                          device=x.device))
    per = max(1, BLOCK_ELEMS // max(1, Bsz * H * L * L))
    ys = []
    for c0 in range(0, T // L, per):
        C = min(T // L - c0, per)
        rows = slice(c0 * L, (c0 + C) * L)
        xh = x[:, rows].float().reshape(Bsz, C, L, H, P).permute(0, 1, 3, 2, 4)
        dtc = dt[:, rows].float().reshape(Bsz, C, L, H)          # (B,C,L,H)
        bc = Bm[:, rows].float().reshape(Bsz, C, L, N)
        cc = Cm[:, rows].float().reshape(Bsz, C, L, N)
        dA = dtc * A
        cs = torch.cumsum(dA, dim=2)                               # (B,C,L,H)
        dt_h = dtc.transpose(2, 3)                                 # (B,C,H,L)
        # intra-chunk quadratic form
        Lm = torch.exp(_segsum(dA.transpose(2, 3)))              # (B,C,H,L,L)
        W = (cc @ bc.transpose(-1, -2))[:, :, None] * Lm * dt_h[..., None, :]
        y = W @ xh                                               # (B,C,H,L,P)
        # each chunk's state from zero, then carried across the chunks
        w = torch.exp(cs[:, :, -1:] - cs).transpose(2, 3) * dt_h  # (B,C,H,L)
        states = (xh * w[..., None]).transpose(-1, -2) @ bc[:, :, None]
        decay = torch.exp(cs[:, :, -1])                            # (B,C,H)
        entering = []
        for c in range(C):
            entering.append(h)
            h = h * decay[:, c][..., None, None] + states[:, c]
        h_in = torch.stack(entering, dim=1)                      # (B,C,H,P,N)
        # inter-chunk contribution from the state entering each chunk
        y = y + (cc[:, :, None] @ h_in.transpose(-1, -2)) \
            * torch.exp(cs).transpose(2, 3)[..., None]
        ys.append(y.permute(0, 1, 3, 2, 4).reshape(Bsz, C * L, H, P)
                  .to(x.dtype))
    y = (torch.cat(ys, dim=1) if ys
         else torch.empty((Bsz, 0, H, P), dtype=x.dtype, device=x.device))
    return y, h.to(x.dtype)
