"""Pieces the family references share: the weight init, norms, RoPE,
blockwise attention, the chunked loss, the float8 control's rounding and
AdamW, all plain float32 PyTorch.

The arithmetic follows the port's model definitions where they depart
from the published ones (``PERF.md`` lists each departure): RMSNorm with
eps 1e-6 and a ``1 + scale`` gain, RoPE over adjacent pairs, weights kept
as (in, out).  Nothing here rounds to bfloat16 except where the
configuration states bfloat16 storage: the parameters and AdamW's moments
after each update (:func:`adamw_update`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
RMS_EPS = 1e-6
#: the largest normal float8 e4m3 value
FP8_MAX = 448.0
#: queries a block in the blockwise attention, tokens a block in the loss
ATTN_BLOCK = 1024
LOSS_BLOCK = 2048


@contextlib.contextmanager
def full_float32():
    """float32 matmuls in full float32 (TF32 off), restored on exit."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was[0]
        torch.backends.cudnn.allow_tf32 = was[1]
        torch.set_float32_matmul_precision(was[2])


# ---------------------------------------------------------------------------
# Weight init: one generator draw for every normal leaf
# ---------------------------------------------------------------------------

#: a leaf: (path, shape, dtype, kind, scale); kind is "normal" (times
#: scale), "zeros", "ones" or "log_arange" (log 1..n)
Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], torch.dtype, str, float]


def init_leaves(leaves: Sequence[Leaf], seed: int, device) -> Dict:
    """The weights of ``leaves`` as a nested tree (dict keys and list
    indices from each path).  Every normal leaf is a view into one buffer
    filled by a single draw of a ``torch.Generator`` on ``device`` seeded
    with ``seed``, in its stored dtype; the leaves are laid out scale by
    scale, so one multiply a scale follows.  Offsets are 256-element
    aligned."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    normal = [lf for lf in leaves if lf[3] == "normal"]
    dtypes = {lf[2] for lf in normal}
    if len(dtypes) > 1:
        raise ValueError(f"normal leaves of several dtypes: {dtypes}")
    scales = sorted({lf[4] for lf in normal})
    order = sorted(range(len(normal)),
                   key=lambda i: scales.index(normal[i][4]))
    offsets, total = {}, 0
    for i in order:
        offsets[i] = total
        total += -(-math.prod(normal[i][1]) // 256) * 256
    values: Dict[Tuple, torch.Tensor] = {}
    if normal:
        buf = torch.empty(total, dtype=normal[0][2], device=device)
        buf.normal_(generator=gen)
        for s in scales:
            idx = [i for i in order if normal[i][4] == s]
            lo = offsets[idx[0]]
            hi = offsets[idx[-1]] + math.prod(normal[idx[-1]][1])
            buf[lo:hi].mul_(s)
        for i, lf in enumerate(normal):
            n = math.prod(lf[1])
            values[lf[0]] = buf[offsets[i]:offsets[i] + n].view(lf[1])
    for path, shape, dtype, kind, _ in leaves:
        if kind == "zeros":
            values[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "ones":
            values[path] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "log_arange":
            values[path] = torch.log(torch.arange(
                1, shape[0] + 1, dtype=torch.float32, device=device)).to(dtype)
        elif kind != "normal":
            raise ValueError(f"unknown init kind {kind!r}")
    return build_tree([(lf[0], values[lf[0]]) for lf in leaves])


def build_tree(items: Sequence[Tuple[Tuple[Any, ...], Any]]) -> Dict:
    """A nested tree from (path, value) pairs: string steps are dict keys,
    integer steps list indices (given in order)."""
    root: Dict = {}
    for path, value in items:
        node: Any = root
        for step, nxt in zip(path[:-1], path[1:]):
            if isinstance(step, int):
                while len(node) <= step:
                    node.append({} if not isinstance(nxt, int) else [])
                node = node[step]
            else:
                if step not in node:
                    node[step] = [] if isinstance(nxt, int) else {}
                node = node[step]
        last = path[-1]
        if isinstance(last, int):
            while len(node) <= last:
                node.append(None)
        node[last] = value
    return root


def flatten(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs, dict keys in sorted order, lists in order."""
    if isinstance(tree, dict):
        out: List = []
        for k in sorted(tree):
            out += flatten(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def path_name(path: Tuple) -> str:
    return "/".join(str(s) for s in path)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

class _RoundFP8(torch.autograd.Function):
    """A tensor rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude onto 448), back in float32; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def gemm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w in float32, or with both operands rounded to float8 first
    (the control)."""
    if precision == "fp8":
        return _RoundFP8.apply(x) @ _RoundFP8.apply(w)
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                           + RMS_EPS) * (1.0 + scale)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (B, S, heads, hd): the pair (2i, 2i+1) rotated by position ·
    theta^(-2i/hd)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions.float()[:, None] * freqs                  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def maybe_checkpoint(fn: Callable, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = ATTN_BLOCK) -> torch.Tensor:
    """Softmax(q kᵀ / √hd) v over keys at or before each query, heads
    grouped over the kv heads.  q (B, S, H, hd), k and v (B, S, KV, hd) →
    (B, S, H, hd).  Blocks of ``block`` queries at a time, each
    recomputed in the backward pass, so no (S, S) score matrix is held."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    kt = k.permute(0, 2, 1, 3).unsqueeze(2)                  # B,KV,1,S,hd
    vt = v.permute(0, 2, 1, 3).unsqueeze(2)
    outs = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        qb = q[:, s0:s1].reshape(B, s1 - s0, KV, G, hd).permute(0, 2, 3, 1, 4)
        outs.append(maybe_checkpoint(_attend, qb, kt[:, :, :, :s1],
                                      vt[:, :, :, :s1], s0, scale))
    out = torch.cat(outs, dim=3)                             # B,KV,G,S,hd
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def _attend(qb, kb, vb, s0: int, scale: float):
    s = (qb * scale) @ kb.transpose(-1, -2)                   # B,KV,G,Qb,M
    q_pos = s0 + torch.arange(qb.shape[3], device=qb.device)[:, None]
    k_pos = torch.arange(kb.shape[3], device=qb.device)[None, :]
    s = s.masked_fill(k_pos > q_pos, float("-inf"))
    return torch.softmax(s, dim=-1) @ vb


def mean_cross_entropy(h: torch.Tensor, table: torch.Tensor,
                       labels: torch.Tensor, vocab: int, precision: str,
                       block: int = LOSS_BLOCK) -> torch.Tensor:
    """Mean next-token NLL of final hidden states ``h`` (N, D) under the
    logits h · tableᵀ over the first ``vocab`` rows (the rest are padding
    the port masks out), ``block`` tokens at a time."""
    total = h.new_zeros(())
    for i in range(0, h.shape[0], block):
        total = total + maybe_checkpoint(_nll_sum, h[i:i + block], table,
                                          labels[i:i + block], vocab,
                                          precision)
    return total / h.shape[0]


def _nll_sum(hb, table, lb, vocab: int, precision: str):
    logits = gemm(hb, table[:vocab].t(), precision)
    gold = torch.gather(logits, 1, lb[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


# ---------------------------------------------------------------------------
# AdamW as the port's trainer configures it
# ---------------------------------------------------------------------------

#: the trainer's optimizer settings (``launch/steps.py::make_optimizer``)
ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
         "clip": 1.0, "final_frac": 0.1}


def learning_rate(step: int, peak_lr: float, total_steps: int) -> float:
    """Linear warm-up over min(500, total_steps // 10 + 1) steps, then a
    cosine decay to a tenth of the peak by ``total_steps`` (step from 1),
    rounded to float32."""
    warm = min(500, total_steps // 10 + 1)
    if step < warm:
        lr = peak_lr * step / max(warm, 1)
    else:
        prog = min(max((step - warm) / max(total_steps - warm, 1), 0.0), 1.0)
        f = ADAMW["final_frac"]
        lr = peak_lr * (f + (1 - f) * 0.5 * (1 + math.cos(math.pi * prog)))
    return float(torch.tensor(lr, dtype=torch.float32))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).float()


@torch.no_grad()
def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 m: List[torch.Tensor], v: List[torch.Tensor],
                 dtypes: List[torch.dtype], step: int, lr: float) -> None:
    """One AdamW step in float32, in place: the gradients scaled to a
    global norm of at most ``clip``; the moments and the new parameters
    stored in each leaf's configured dtype (rounded to it and held as
    float32 here)."""
    a = ADAMW
    gnorm = global_norm(grads)
    scale = torch.clamp(a["clip"] / (gnorm + 1e-12), max=1.0)
    c1 = 1.0 - a["b1"] ** step
    c2 = 1.0 - a["b2"] ** step
    for p, g, mi, vi, dt in zip(params, grads, m, v, dtypes):
        g = g * scale
        m32 = mi * a["b1"] + g * (1 - a["b1"])
        v32 = vi * a["b2"] + g * g * (1 - a["b2"])
        delta = (m32 / c1) / (torch.sqrt(v32 / c2) + a["eps"]) \
            + a["weight_decay"] * p
        p.copy_((p - lr * delta).to(dt).float())
        mi.copy_(m32.to(dt).float())
        vi.copy_(v32.to(dt).float())


def clip_scale(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.clamp(ADAMW["clip"] / (global_norm(grads) + 1e-12), max=1.0)
