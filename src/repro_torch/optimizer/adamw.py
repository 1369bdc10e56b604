"""AdamW over trees of tensors (:mod:`repro_torch.tree`): the port of the
JAX package's ``optimizer/adamw.py``.

Written out rather than ``torch.optim.AdamW``, because the parity bar is
the reference's rounding: the update math runs in float32 and is cast
back to the parameter's dtype; ``state_dtype`` keeps the moments in
another dtype (bfloat16 for the largest models), rounded there after every
update; weight decay is added to the normalised step (``delta + wd·p``)
before ``p − lr·delta``; the clip scale multiplies the float32 gradient.
``update`` is functional: it returns new parameter and state trees and
leaves its inputs as they were.  ``lr`` is a float or ``callable(step)``
(step an int32 tensor, from 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from .. import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamW:
    lr: Any = 1e-3                    # float or callable(step) -> float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    state_dtype: Optional[torch.dtype] = None   # None → the param's dtype

    def init(self, params: Any) -> AdamWState:
        def zeros_like(p):
            return torch.zeros(p.shape, dtype=self.state_dtype or p.dtype,
                               device=p.device)
        device = T.leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=T.map(zeros_like, params),
                          v=T.map(zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any):
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        scale = None
        if self.grad_clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip_norm / (gnorm + 1e-12),
                                max=1.0)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=step.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=step.device), stepf)

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            if scale is not None:
                g32 = g32 * scale
            m32 = m.to(torch.float32) * b1 + g32 * (1 - b1)
            v32 = v.to(torch.float32) * b2 + torch.square(g32) * (1 - b2)
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
            return new_p, m32.to(m.dtype), v32.to(v.dtype)

        new = [upd(g, m, v, p) for g, m, v, p in
               zip(T.leaves(grads), T.leaves(state.m), T.leaves(state.v),
                   T.leaves(params))]
        return (T.unflatten(params, [n[0] for n in new]),
                AdamWState(step=step,
                           m=T.unflatten(state.m, [n[1] for n in new]),
                           v=T.unflatten(state.v, [n[2] for n in new])))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sums = [torch.sum(torch.square(leaf.to(torch.float32)))
            for leaf in T.leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def sgd_update(grads: Any, params: Any, lr) -> Any:
    return T.map(lambda p, g: p - lr * g, params, grads)
