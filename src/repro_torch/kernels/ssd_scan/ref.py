"""Plain torch version of the chunked SSD kernel: the port of the JAX
package's oracle ``models/ssd.py::ssd_scan_ref``, which the model's SSD
block (``models/ssd.py``) imports from here.

Arithmetic as the oracle: float32 throughout, the intra-chunk decay as
``exp`` of a pairwise segment sum masked to -inf above the diagonal;
blocks of chunks at a time (see :func:`ssd_ref`).

:func:`ssd_bwd_ref` is the plain twin of the backward kernel
(``csrc/ssd_scan_bwd.cu``): the same gradient, written out chunk by chunk
in the kernel's terms, float32.  The tests hold it to ``jax.vjp`` of the
reference; nothing on the card's path calls it.
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


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, gy: torch.Tensor,
                gstate: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_ref` (zero initial state) from y's
    cotangent ``gy`` (B,T,H,P) and the final state's ``gstate``
    (B,H,P,N): (dx, ddt, dA, dB, dC), dx, dB and dC in x's dtype, ddt and
    dA float32.  Float32 throughout, all chunks at once (for the tests'
    sizes).

    Per chunk, with cs = cumsum(dt·A), G = C·Bᵀ, D_ls = exp(cs_l − cs_s)
    for s ≤ l, w_s = exp(cs_{L−1} − cs_s)·dt_s, h the state entering the
    chunk and dh the cotangent of the state leaving it (``gstate`` for the
    last chunk; dh_c = exp(cs_{L−1})·dh_{c+1} + Σ_l exp(cs_l) gy_l ⊗ C_l):
    M_ls = gy_l·x_s and E = G ⊙ D ⊙ M; dx = (G⊙D⊙dt)ᵀ·gy + w·(B·dhᵀ);
    dC = Σ_heads (M⊙D⊙dt)·B + exp(cs)·(gy·h); dB = Σ_heads (M⊙D⊙dt)ᵀ·C
    + w·(x·dh); the decay's cotangent dcs_l = Σ_s E_ls dt_s + exp(cs_l)
    ⟨gy_l·h, C_l⟩ − dt_l (Σ_k E_kl + u_l), u_l = exp(cs_{L−1} − cs_l)
    ⟨x_l·dh, B_l⟩, and at the chunk's last step also Σ_s dt_s u_s +
    exp(cs_{L−1}) ⟨h, dh⟩; da = its reverse cumsum, ddt = A·da + Σ_k E_kl
    + u_l and dA = Σ dt·da."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk
    nc = T // L
    xc = x.float().reshape(Bsz, nc, L, H, P).permute(0, 1, 3, 2, 4)
    gyc = gy.float().reshape(Bsz, nc, L, H, P).permute(0, 1, 3, 2, 4)
    dtc = dt.float().reshape(Bsz, nc, L, H).permute(0, 1, 3, 2)  # (B,c,H,L)
    bc = Bm.float().reshape(Bsz, nc, 1, L, N)
    cc = Cm.float().reshape(Bsz, nc, 1, L, N)
    Af = A.float()
    cs = torch.cumsum(dtc * Af[:, None], dim=-1)
    last = cs[..., -1:]
    ecs = torch.exp(cs)
    D = torch.exp(_segsum(dtc * Af[:, None]))                  # (B,c,H,L,L)
    GD = (cc @ bc.transpose(-1, -2)) * D
    w = torch.exp(last - cs) * dtc
    decay = torch.exp(last[..., 0])                            # (B,c,H)
    # the states entering each chunk, and the cotangents leaving each
    local = (xc * w[..., None]).transpose(-1, -2) @ bc          # (B,c,H,P,N)
    dlocal = (gyc * ecs[..., None]).transpose(-1, -2) @ cc
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    dh = gstate.float()
    h_in, dh_out = [], [None] * nc
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + local[:, c]
    for c in reversed(range(nc)):
        dh_out[c] = dh
        dh = dh * decay[:, c, :, None, None] + dlocal[:, c]
    h_in = torch.stack(h_in, dim=1)
    dh_out = torch.stack(dh_out, dim=1)
    M = gyc @ xc.transpose(-1, -2)                             # (B,c,H,L,L)
    E = GD * M
    Md = M * D * dtc[..., None, :]
    gyh = gyc @ h_in                                           # (B,c,H,L,N)
    xdh = xc @ dh_out                                          # (B,c,H,L,N)
    dx = ((GD * dtc[..., None, :]).transpose(-1, -2) @ gyc
          + w[..., None] * (bc @ dh_out.transpose(-1, -2)))
    dC = (Md @ bc + ecs[..., None] * gyh).sum(2)               # (B,c,L,N)
    dB = (Md.transpose(-1, -2) @ cc + w[..., None] * xdh).sum(2)
    u = torch.exp(last - cs) * (xdh * bc).sum(-1)              # (B,c,H,L)
    direct = E.sum(-2) + u
    dcs = (E * dtc[..., None, :]).sum(-1) + ecs * (gyh * cc).sum(-1) \
        - dtc * direct
    dcs[..., -1] += (dtc * u).sum(-1) + decay * (h_in * dh_out).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = Af[:, None] * da + direct
    dA = (dtc * da).sum((0, 1, 3))
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bsz, T, H, P).to(x.dtype),
            ddt.permute(0, 1, 3, 2).reshape(Bsz, T, H), dA,
            dB.reshape(Bsz, T, N).to(x.dtype),
            dC.reshape(Bsz, T, N).to(x.dtype))
