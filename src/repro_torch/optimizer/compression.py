"""Gradient compression with error feedback: the port of the JAX package's
``optimizer/compression.py`` (int8 uniform quantization, top-k
sparsification; what compression drops is re-injected on the next step).

The reference compresses per pytree leaf, and its LM parameters stack the
pattern slots over the scanned groups, so one int8 scale and one top-k
threshold cover a slot's leaf across all its layers.  The port keeps one
dict per layer; passed the model's ``cfg``, these functions group the
port's leaves as the reference's (:func:`..models.convert.reference_path`)
and compute one scale or threshold per group, so values, residuals and
``wire_bytes`` (the reference's formula: int8 payload + a 4-byte scale per
leaf; 8 bytes per kept (index, value) pair) are the reference's.  Without
``cfg`` every tensor is its own leaf.  ``jax.lax.top_k`` and
``torch.topk`` may order ties differently; the threshold is the k-th
largest magnitude either way, and the kept set ``|x| >= threshold`` with
it.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from .. import tree as T


class ErrorFeedbackState(NamedTuple):
    residual: Any     # tree matching grads, float32


def init_error_feedback(grads_like: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=T.map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def _groups(grads: Any, cfg) -> List[List[int]]:
    """Leaf indices (flattening order) of each reference leaf."""
    paths = [p for p, _ in T.flatten_with_paths(grads)]
    if cfg is None:
        return [[i] for i in range(len(paths))]
    from ..models.convert import reference_path
    by_ref: Dict[Tuple, List[Tuple[int, int]]] = {}
    for i, p in enumerate(paths):
        ref, g = reference_path(cfg, p)
        by_ref.setdefault(ref, []).append((g or 0, i))
    return [[i for _, i in sorted(v)] for v in by_ref.values()]


# -- int8 quantization -------------------------------------------------------

def int8_scale(xs: List[torch.Tensor]) -> torch.Tensor:
    """One scale for the tensors of a leaf: max|x| / 127 + 1e-12."""
    amax = torch.stack([x.abs().amax() for x in xs]).amax()
    return amax / 127.0 + 1e-12


def quantize_int8(x: torch.Tensor, scale=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = int8_scale([x]) if scale is None else scale
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_int8(grads: Any, ef: ErrorFeedbackState, cfg=None):
    """Returns (decompressed grads, new EF state, wire_bytes)."""
    gs = T.leaves(grads)
    xs = [g.to(torch.float32) + r for g, r in zip(gs, T.leaves(ef.residual))]
    deq: List[Any] = [None] * len(gs)
    groups = _groups(grads, cfg)
    for group in groups:
        scale = int8_scale([xs[i] for i in group])
        for i in group:
            deq[i] = dequantize_int8(quantize_int8(xs[i], scale)[0], scale)
    wire_bytes = sum(sum(gs[i].numel() for i in group) + 4
                     for group in groups)
    new_g = T.unflatten(grads, [d.to(g.dtype) for d, g in zip(deq, gs)])
    new_r = T.unflatten(grads, [x - d for x, d in zip(xs, deq)])
    return new_g, ErrorFeedbackState(new_r), wire_bytes


# -- top-k sparsification ------------------------------------------------------

@torch.no_grad()
def compress_topk(grads: Any, ef: ErrorFeedbackState, frac: float = 0.05,
                  cfg=None):
    """Keep the top-|x| ``frac`` of each leaf's entries; the rest go to the
    residual.  Returns (grads, new EF state, wire_bytes)."""
    gs = T.leaves(grads)
    xs = [g.to(torch.float32) + r for g, r in zip(gs, T.leaves(ef.residual))]
    kept: List[Any] = [None] * len(gs)
    wire_bytes = 0
    for group in _groups(grads, cfg):
        flat = torch.cat([xs[i].reshape(-1) for i in group])
        k = max(1, int(flat.numel() * frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        for i in group:
            kept[i] = xs[i] * (xs[i].abs() >= thresh).to(torch.float32)
        wire_bytes += k * 8          # (int32 idx, fp32 val) pairs
    new_g = T.unflatten(grads, [c.to(g.dtype) for c, g in zip(kept, gs)])
    new_r = T.unflatten(grads, [x - c for x, c in zip(xs, kept)])
    return new_g, ErrorFeedbackState(new_r), wire_bytes
