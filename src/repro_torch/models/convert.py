"""Carry weights (and caches) of the JAX package's model into the port.

The JAX model keeps the pattern slots stacked over the G scanned groups
(``blocks/s{s}``, leading axis G) plus unrolled ``prefix{i}``/``tail{i}``
layers; the port keeps one dict per layer in execution order.  The input
is the JAX pytree with its leaves as numpy arrays (``jax.tree.map(
np.asarray, tree)``), so this module needs no JAX.  ``dense`` weights keep
their (din, dout) orientation.  bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses; they go
across as their uint16 bits, so every value is exact.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..configs.base import ArchConfig


def to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    """One numpy leaf → a tensor that owns a copy of its bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(cfg: ArchConfig, tree: Dict[str, Any]) -> List[Any]:
    """The per-layer subtrees of a JAX params or cache tree, in execution
    order: ``prefix{i}``, then for each group g every slot ``blocks/s{s}``
    at index g, then ``tail{i}``.  Leaves stay numpy."""
    layers: List[Any] = [tree[f"prefix{i}"] for i in range(len(cfg.prefix))]
    for g in range(cfg.pattern_groups):
        for s in range(len(cfg.pattern)):
            layers.append(_map(tree["blocks"][f"s{s}"], lambda a: a[g]))
    layers += [tree[f"tail{i}"] for i in range(len(cfg.tail_specs))]
    return layers


def params_from_jax(cfg: ArchConfig, params_np: Dict[str, Any],
                    device="cpu") -> Dict[str, Any]:
    """The JAX ``T.init_params`` tree (numpy leaves) → the port's params
    (:mod:`.transformer`) on ``device``."""
    conv = lambda a: to_torch(a, device)               # noqa: E731
    out: Dict[str, Any] = {
        k: _map(params_np[k], conv)
        for k in ("embed", "final_norm", "unembed") if k in params_np}
    out["layers"] = [_map(layer, conv)
                     for layer in unstack_layers(cfg, params_np)]
    return out
