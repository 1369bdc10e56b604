"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

The port of the JAX package's ``models/ssd.py``.  Within a chunk the
recurrence is a masked attention-like quadratic form; across chunks a
(H, P, N) state is carried.  Prefill runs the chunked scan through the SSD
kernel (:mod:`..kernels.ssd_scan.ops`: the CUDA kernel on the card, the
plain ``ssd_scan_ref`` on the CPU; it lives in ``kernels/ssd_scan/ref.py``
and is imported here under the reference's name).  Decode keeps the
recurrent state: h ← dA·h + dt·B⊗x, y = C·h + D·x, in torch einsums as in
the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan.ref import ssd_ref as ssd_scan_ref  # noqa: F401
from .layers import (Params, dense, dense_init, pad_zeros, rmsnorm,
                     rmsnorm_init, silu)


def ssd_init(gen: torch.Generator, d_model: int, *, d_inner: int, state: int,
             nheads: int, conv_width: int, dtype, device=None) -> Params:
    d_in_proj = 2 * d_inner + 2 * state + nheads   # z, x, B, C, dt
    conv_w = torch.randn((conv_width, d_inner + 2 * state), generator=gen,
                         dtype=torch.float32, device=device) * 0.2
    return {
        "in_proj": dense_init(gen, d_model, d_in_proj, dtype, device=device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d_inner + 2 * state,), dtype=dtype,
                              device=device),
        "A_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((nheads,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(d_inner, dtype, device),
        "out_proj": dense_init(gen, d_inner, d_model, dtype, device=device),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """x: (B,T,C); w: (W,C) depthwise causal conv."""
    W, T = w.shape[0], x.shape[1]
    pads = pad_zeros(x, (0, 0, W - 1, 0))
    out = sum(pads[:, i:i + T] * w[i] for i in range(W))
    return silu(out + b)


def ssd_block(p: Params, x: torch.Tensor, *, d_inner: int, state: int,
              nheads: int, chunk: int,
              rec_state: Optional[Dict[str, torch.Tensor]] = None,
              return_final_state: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full Mamba-2 mixer.  x: (B,T,D).

    Full sequence: rec_state=None, chunked scan over T (padded to a chunk
    multiple; padded steps have dt=0 and leave the state unchanged).
    Prefill: rec_state=None, return_final_state=True → the decode state.
    Decode: rec_state = {"h": (B,H,P,N), "conv": (B,W-1,Cconv)}; T must be 1.
    """
    B, T, _ = x.shape
    P = d_inner // nheads
    zxbcdt = dense(p["in_proj"], x)
    z = zxbcdt[..., :d_inner]
    dt = zxbcdt[..., 2 * d_inner + 2 * state:]
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,T,H)
    A = -torch.exp(p["A_log"])                                   # (H,)

    # [x, B, C] are adjacent in the projection: their concatenation is a view
    conv_in = zxbcdt[..., d_inner:2 * d_inner + 2 * state]
    W = p["conv_w"].shape[0]
    new_state = None
    if rec_state is None:
        conv_out = _causal_conv1d(conv_in, p["conv_w"], p["conv_b"])
    else:
        hist = torch.cat([rec_state["conv"], conv_in], dim=1)
        conv_out = sum(hist[:, i:i + T] * p["conv_w"][i] for i in range(W))
        conv_out = silu(conv_out + p["conv_b"])
        new_conv = hist[:, -(W - 1):]
    xin = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner:d_inner + state]
    Cm = conv_out[..., d_inner + state:]
    xh = xin.reshape(B, T, nheads, P)

    if rec_state is None:
        T_pad = -(-T // chunk) * chunk
        xs, dts, Bs, Cs = xh, dt, Bm, Cm
        if T_pad != T:
            pad = T_pad - T
            xs = pad_zeros(xh, (0, 0, 0, 0, 0, pad))
            dts = pad_zeros(dt, (0, 0, 0, pad))
            Bs = pad_zeros(Bm, (0, 0, 0, pad))
            Cs = pad_zeros(Cm, (0, 0, 0, pad))
        y, final = ssd_ops.ssd(xs, dts, A, Bs, Cs, chunk=chunk)
        y = y[:, :T]
        if return_final_state:
            # a copy: a view would keep the whole projection alive
            new_state = {"h": final,
                         "conv": conv_in[:, -(W - 1):].clone()}
    else:
        # single-token recurrent update
        dA = torch.exp(dt[:, 0] * A)                              # (B,H)
        h = rec_state["h"].float()
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0].float(),
                           Bm[:, 0].float())
        h = h * dA[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
        y = y[:, None].reshape(B, 1, nheads, P).to(x.dtype)
        new_state = {"h": h.to(rec_state["h"].dtype), "conv": new_conv}

    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(B, T, d_inner)
    y = rmsnorm(p["norm"], y * silu(z))
    return dense(p["out_proj"], y), new_state


def ssd_state_shape(B: int, d_inner: int, state: int, nheads: int,
                    conv_width: int) -> Dict[str, Tuple[int, ...]]:
    return {"h": (B, nheads, d_inner // nheads, state),
            "conv": (B, conv_width - 1, d_inner + 2 * state)}


def ssd_state_init(B: int, d_inner: int, state: int, nheads: int,
                   conv_width: int, dtype, device=None
                   ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, shape in ssd_state_shape(B, d_inner, state, nheads,
                                            conv_width).items()}
