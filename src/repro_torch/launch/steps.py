"""Train / serve step factories: the port of the JAX package's
``launch/steps.py``.

``train_step(state, batch) -> (state, metrics)`` is functional, as the
reference's: the state's parameter, optimizer and error-feedback trees
are replaced, never updated in place — unless it is made with
``donate=True``, the counterpart of the reference trainer's
``donate_argnums``, which writes the new parameters and moments into the
given state's tensors.  Gradients come from
``torch.autograd.grad`` of :func:`..models.transformer.loss_fn`; on the
card the mixers run the hand-written kernels forward and the plain
twins' VJPs backward (``kernels/*/ops.py``).  ``cfg.accum_steps > 1``
splits the batch into microbatches in a Python loop (the reference's
``lax.scan``), one microbatch's activations live at a time.

With tracing on (``repro_torch.obs``), a step records the phase spans
``lm.train_step`` ⊃ ``lm.forward``, ``lm.backward`` (one of each a
microbatch) and ``lm.optimizer``; none of them synchronizes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .. import tree as T
from ..configs.base import ArchConfig
from ..models import transformer as TM
from ..obs.tracer import span as _span
from ..optimizer.adamw import AdamW, global_norm
from ..optimizer.schedule import warmup_cosine


def make_optimizer(cfg: ArchConfig, peak_lr: float = 3e-4,
                   total_steps: int = 10_000) -> AdamW:
    return AdamW(lr=warmup_cosine(peak_lr, min(500, total_steps // 10 + 1),
                                  total_steps),
                 b1=0.9, b2=0.95, weight_decay=0.1, grad_clip_norm=1.0,
                 state_dtype=torch.bfloat16 if cfg.opt_state_bf16 else None)


def init_train_state(cfg: ArchConfig, gen: torch.Generator, optimizer: AdamW,
                     compression: Optional[str] = None,
                     device=None) -> Dict[str, Any]:
    """Random weights from ``gen`` (a ``torch.Generator`` on ``device``)
    and a fresh optimizer state; ``compression`` adds the error-feedback
    residual."""
    params = TM.init_params(cfg, gen, device)
    state = {"params": params, "opt": optimizer.init(params)}
    if compression:
        from ..optimizer.compression import init_error_feedback
        state["ef"] = init_error_feedback(params)
    return state


def value_and_grad(cfg: ArchConfig, params: Any, batch: Dict[str, Any]):
    """(loss, metrics, gradient tree of ``params``) of one batch."""
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    with _span("lm.forward", "lm"):
        loss, met = TM.loss_fn(cfg, T.unflatten(params, leaves), batch)
    with _span("lm.backward", "lm"):
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in met.items()}, \
        T.unflatten(params, list(grads))


def make_train_step(cfg: ArchConfig, optimizer: AdamW,
                    compression: Optional[str] = None,
                    topk_frac: float = 0.05,
                    donate: bool = False) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``compression`` ∈ {None, "int8", "topk"}: compress the gradients with
    error feedback before the update (the state carries the residual),
    one scale or threshold per stacked leaf of the reference's layout
    (``optimizer/compression.py``); the wire-byte count is returned in
    metrics.  ``donate=True`` (the reference trainer's ``donate_argnums``)
    writes the new parameters and moments into the given state's tensors
    (``AdamW.update(donate=True)``): the same bits, one copy of the state
    in memory; the caller's ``state`` then holds the new values."""

    def train_step(state, batch):
        with _span("lm.train_step", "lm"):
            params = state["params"]
            A = cfg.accum_steps
            if A == 1:
                loss, met, grads = value_and_grad(cfg, params, batch)
            else:
                grads = loss = None
                for a in range(A):
                    mb = {k: _microbatch(v, A, a) for k, v in batch.items()}
                    l, _m, g = value_and_grad(cfg, params, mb)
                    grads = g if grads is None else T.map(torch.add, grads, g)
                    loss = l if loss is None else loss + l
                grads = T.map(lambda g: g / A, grads)
                loss = loss / A
                met = {"ce": loss,
                       "moe_aux": torch.zeros((), dtype=torch.float32,
                                              device=loss.device)}
            new_state = {}
            with _span("lm.optimizer", "lm"):
                gnorm = global_norm(grads)
                if compression is not None:
                    from ..optimizer import compression as C
                    ef = state["ef"]
                    if compression == "int8":
                        grads, ef, wire = C.compress_int8(grads, ef, cfg=cfg)
                    elif compression == "topk":
                        grads, ef, wire = C.compress_topk(grads, ef,
                                                          frac=topk_frac, cfg=cfg)
                    else:
                        raise ValueError(compression)
                    new_state["ef"] = ef
                    met = dict(met, wire_bytes=wire)
                new_params, new_opt = optimizer.update(grads, state["opt"],
                                                       params, donate=donate)
            metrics = {"loss": loss, "grad_norm": gnorm, **met}
            new_state.update({"params": new_params, "opt": new_opt})
            return new_state, metrics

    return train_step


def _microbatch(v: torch.Tensor, A: int, a: int) -> torch.Tensor:
    """Microbatch ``a`` of ``A``: the reference's contiguous block of rows.
    A ``DTensor`` batch sharded over n ranks is split rank by rank
    instead (block ``a`` of each rank's rows), so that no rank's rows
    move; the microbatches' mean loss and summed gradient are the same."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(v, DTensor):
        return v.reshape((A, v.shape[0] // A) + v.shape[1:])[a]
    n = 1
    for size, pl in zip(v.device_mesh.shape, v.placements):
        if pl == Shard(0):
            n *= size
    rest = tuple(v.shape[1:])
    return v.reshape((n, A, v.shape[0] // (n * A)) + rest)[:, a].reshape(
        (v.shape[0] // A,) + rest)


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        return TM.prefill(cfg, params, batch["tokens"],
                          frames=batch.get("frames"))
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def decode_step(params, cache, tokens, pos):
        return TM.decode_step(cfg, params, cache, tokens, pos)
    return decode_step
