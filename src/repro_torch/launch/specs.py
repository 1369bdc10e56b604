"""Shape-only stand-ins for every model input (no allocation): the port of
the JAX package's ``launch/specs.py``.

``input_specs(cfg, shape)`` returns everything a step function runs with:
train → (state, batch); prefill → (params, batch); decode → (params,
cache, tokens, pos).  The same trees feed the sharding rules.

Where the reference's ``jax.eval_shape`` abstracts its initialisers, the
port runs its own (``init_params``, ``init_train_state``, ``init_cache``)
on the ``meta`` device: the trees the steps take, with every leaf's shape
and dtype and no storage.  (A fake CUDA tensor would do the same on a
card's build of torch, but a CPU-only build cannot index one: its
``__getitem__`` asks for a CUDA device guard.)  The decode position is a
Python int, as the port's ``decode_step`` takes it: the last slot of the
cache, so that attention reads the whole cache, as the reference's traced
position must allow for.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models import transformer as T
from ..optimizer.adamw import AdamW
from . import steps

DEVICE = torch.device("meta")


def _gen() -> torch.Generator:
    # the initialisers draw from a generator; on meta nothing is drawn
    return torch.Generator()


def params_struct(cfg: ArchConfig) -> Any:
    return T.init_params(cfg, _gen(), DEVICE)


def state_struct(cfg: ArchConfig, optimizer: AdamW) -> Any:
    return steps.init_train_state(cfg, _gen(), optimizer, device=DEVICE)


def batch_struct(cfg: ArchConfig, shape: ShapeSpec,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None) -> Dict[str, Any]:
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=DEVICE),
           "labels": torch.empty((B, S), dtype=torch.int32, device=DEVICE)}
    if cfg.encoder is not None:
        out["frames"] = torch.empty((B, cfg.encoder.num_frames, cfg.d_model),
                                    dtype=T.dtype_of(cfg), device=DEVICE)
    return out


def cache_struct(cfg: ArchConfig, B: int, Lc: int) -> Any:
    return T.init_cache(cfg, B, Lc, DEVICE)


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                optimizer: Optional[AdamW] = None) -> Dict[str, Any]:
    """All step inputs for one (arch × shape) cell."""
    if shape.kind == "train":
        assert optimizer is not None
        return {"state": state_struct(cfg, optimizer),
                "batch": batch_struct(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_struct(cfg),
                "batch": batch_struct(cfg, shape)}
    if shape.kind == "decode":
        B = shape.global_batch
        return {"params": params_struct(cfg),
                "cache": cache_struct(cfg, B, shape.seq_len),
                "tokens": torch.empty((B, 1), dtype=torch.int32,
                                      device=DEVICE),
                "pos": shape.seq_len - 1}
    raise ValueError(shape.kind)
