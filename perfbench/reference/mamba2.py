"""Plain float32 reference of Mamba-2 (arXiv:2405.21060): attention-free
blocks of the SSD mixer, in the port's parameter layout.

Per layer, with h = norm(x): [z, xBC, dt] = h · W_in; xBC through a
causal depthwise convolution of width ``d_conv`` and silu, split into x
(heads × headdim), B and C (one group, ``d_state`` wide); dt =
softplus(dt + dt_bias); A = −exp(A_log); the SSD recurrence h_t =
exp(dt_t A) h_{t−1} + dt_t x_t ⊗ B_t, y_t = C_t · h_t + D x_t from a zero
state; y = norm(y ⊙ silu(z)) · W_out; x += y.  Final norm, tied logits.

The SSD is the paper's chunked form (its ``ssd_minimal`` listing): the
diagonal blocks as a masked quadratic form, each chunk's state, the states
carried across chunks, their output; segment sums taken by the stable
masked cumulative sum.  Layers are recomputed in the backward pass.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..yardstick.cost import ssd_scan_cost
from . import common as C


def _sizes(spec: Dict) -> Dict:
    c = spec["config"]
    D = c["d_model"]
    di = c["expand"] * D
    P = c["headdim"]
    vocab = c["vocab_size"]
    pad = spec["layout"]["vocab_pad_multiple"]
    return {"D": D, "di": di, "N": c["d_state"], "H": di // P, "P": P,
            "W": c["d_conv"], "L": c["chunk_size"], "layers": c["n_layer"],
            "V": vocab, "Vp": -(-vocab // pad) * pad,
            "tied": bool(c["tie_embeddings"]),
            "dtype": C.DTYPES[c["torch_dtype"]]}


def program_fields(spec: Dict) -> Dict:
    s = _sizes(spec)
    return {"d_model": s["D"], "num_layers": s["layers"],
            "vocab_size": s["V"], "padded_vocab": s["Vp"],
            "tie_embeddings": s["tied"],
            "param_dtype": spec["config"]["torch_dtype"], "norm": "rmsnorm",
            "positional": "none", "embed_scale": False,
            "logit_softcap": 0.0, "use_post_norm": False,
            "ssd.d_inner": s["di"], "ssd.state": s["N"],
            "ssd.nheads": s["H"], "ssd.conv_width": s["W"],
            "ssd.chunk": s["L"],
            "mixers": ["ssd"] * s["layers"], "ffns": ["none"] * s["layers"]}


def leaves(spec: Dict) -> List[C.Leaf]:
    s = _sizes(spec)
    D, di, N, H, W, dt = s["D"], s["di"], s["N"], s["H"], s["W"], s["dtype"]
    f32 = torch.float32
    out: List[C.Leaf] = [(("embed", "table"), (s["Vp"], D), dt, "normal",
                          0.02),
                         (("final_norm", "scale"), (D,), dt, "zeros", 0.0)]
    if not s["tied"]:
        out.append((("unembed", "table"), (s["Vp"], D), dt, "normal", 0.02))
    for i in range(s["layers"]):
        L = ("layers", i)
        out += [
            (L + ("ln_attn", "scale"), (D,), dt, "zeros", 0.0),
            (L + ("attn", "in_proj", "w"), (D, 2 * di + 2 * N + H), dt,
             "normal", 1 / math.sqrt(D)),
            (L + ("attn", "conv_w"), (W, di + 2 * N), dt, "normal", 0.2),
            (L + ("attn", "conv_b"), (di + 2 * N,), dt, "zeros", 0.0),
            (L + ("attn", "A_log"), (H,), f32, "log_arange", 0.0),
            (L + ("attn", "D"), (H,), f32, "ones", 0.0),
            (L + ("attn", "dt_bias"), (H,), f32, "zeros", 0.0),
            (L + ("attn", "norm", "scale"), (di,), dt, "zeros", 0.0),
            (L + ("attn", "out_proj", "w"), (di, D), dt, "normal",
             1 / math.sqrt(di)),
        ]
    return out


def init_params(spec: Dict, seed: int, device) -> Dict:
    return C.init_leaves(leaves(spec), seed, device)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T): out[i, j] = Σ_{j<k≤i} x_k, −inf above the
    diagonal, by a masked cumulative sum (no difference of long sums)."""
    T = x.shape[-1]
    xx = x[..., None].expand(*x.shape, T)                   # [i, j] = x_i
    low = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    xx = xx.masked_fill(~low, 0.0)
    out = torch.cumsum(xx, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int) -> torch.Tensor:
    """y of the SSD recurrence from a zero state.  x (B,T,H,P), dt (B,T,H),
    A (H,), Bm and Cm (B,T,N); T a multiple of ``chunk``."""
    B, T, H, P = x.shape
    N, L = Bm.shape[-1], chunk
    c = T // L
    X = (x * dt[..., None]).reshape(B, c, L, H, P).permute(0, 1, 3, 2, 4)
    Adt = (dt * A).reshape(B, c, L, H).permute(0, 1, 3, 2)   # B,c,H,L
    Acs = torch.cumsum(Adt, dim=-1)
    Bc, Cc = Bm.reshape(B, c, 1, L, N), Cm.reshape(B, c, 1, L, N)
    # diagonal blocks: y_l = Σ_{s≤l} (C_l·B_s) exp(Σ_{s<k≤l} dA_k) dt_s x_s
    Wd = (Cc @ Bc.transpose(-1, -2)) * torch.exp(segsum(Adt))
    Y = Wd @ X                                              # B,c,H,L,P
    # each chunk's own final state, then the states entering each chunk
    decay_states = torch.exp(Acs[..., -1:] - Acs)           # B,c,H,L
    states = (X * decay_states[..., None]).transpose(-1, -2) @ Bc
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    last = F.pad(Acs[..., -1].permute(0, 2, 1), (1, 0))     # B,H,c+1
    decay_chunk = torch.exp(segsum(last))                   # B,H,c+1,c+1
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y = Y + (Cc @ states.transpose(-1, -2)) * torch.exp(Acs)[..., None]
    return Y.permute(0, 1, 3, 2, 4).reshape(B, T, H, P)


def _layer(x, p, s, precision):
    B, T, _ = x.shape
    di, N, H, P, W = s["di"], s["N"], s["H"], s["P"], s["W"]
    a = p["attn"]
    h = C.rmsnorm(x, p["ln_attn"]["scale"])
    zxbcdt = C.gemm(h, a["in_proj"]["w"], precision)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * N]
    dt = F.softplus(zxbcdt[..., 2 * di + 2 * N:] + a["dt_bias"])
    A = -torch.exp(a["A_log"])
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(padded[:, i:i + T] * a["conv_w"][i] for i in range(W))
    conv = C.silu(conv + a["conv_b"])
    xs = conv[..., :di].reshape(B, T, H, P)
    Bm, Cm = conv[..., di:di + N], conv[..., di + N:]
    y = ssd(xs, dt, A, Bm, Cm, s["L"]) + a["D"][:, None] * xs
    y = C.rmsnorm(y.reshape(B, T, di) * C.silu(z), a["norm"]["scale"])
    return x + C.gemm(y, a["out_proj"]["w"], precision)


def _hidden(spec, params, tokens, precision):
    s = _sizes(spec)
    if tokens.shape[1] % s["L"]:
        raise ValueError(f"sequence {tokens.shape[1]} is not a multiple of "
                         f"the chunk {s['L']}")
    x = params["embed"]["table"][tokens.long()]
    for p in params["layers"]:
        x = C.maybe_checkpoint(lambda x_, p_: _layer(x_, p_, s, precision),
                                x, p)
    return C.rmsnorm(x, params["final_norm"]["scale"])


def _head(spec, params):
    return params["embed" if _sizes(spec)["tied"] else "unembed"]["table"]


def loss(spec: Dict, params: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    h = _hidden(spec, params, tokens, precision)
    return C.mean_cross_entropy(h.reshape(-1, h.shape[-1]),
                                _head(spec, params), labels.reshape(-1),
                                _sizes(spec)["V"], precision)


@torch.no_grad()
def logits_at(spec: Dict, params: Dict, tokens: torch.Tensor,
              positions: Sequence[int], precision: str = "fp32"
              ) -> torch.Tensor:
    """Logits at the given positions; ``tokens`` is right-padded with id 0
    to a chunk multiple (the recurrence is causal, so padding after a
    position changes nothing before it)."""
    s = _sizes(spec)
    T = tokens.shape[1]
    pad = -T % s["L"]
    if pad:
        tokens = F.pad(tokens, (0, pad))
    h = _hidden(spec, params, tokens, precision)[:, list(positions)]
    return C.gemm(h, _head(spec, params)[:s["V"]].t(), precision)


def forward_flops(spec: Dict, batch: int, seq: int,
                  head_positions: int) -> float:
    """Model FLOPs of one forward pass: 2 a multiply-add of the in and out
    projections and the head, plus the chunked SSD's products (the
    diagonal blocks' C·Bᵀ and W·x over the causal triangle, each chunk's
    state and its read-out), as the frozen ``ssd_scan_cost`` counts
    them."""
    s = _sizes(spec)
    D, di, N, H, P, L = s["D"], s["di"], s["N"], s["H"], s["P"], s["L"]
    proj = D * (2 * di + 2 * N + H) + di * D
    T = -(-seq // L) * L
    scan, _ = ssd_scan_cost(batch, T, H, P, N, L, 2)
    return (s["layers"] * (2.0 * proj * batch * seq + scan)
            + 2.0 * D * s["V"] * head_positions * batch)


def train_flops(spec: Dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(spec, batch, seq, seq)
