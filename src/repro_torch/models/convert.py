"""Carry weights (and caches) of the JAX package's model into the port.

The JAX model keeps the pattern slots stacked over the G scanned groups
(``blocks/s{s}``, leading axis G) plus unrolled ``prefix{i}``/``tail{i}``
layers; the port keeps one dict per layer in execution order.  An
encoder's layers are stacked over their count in ``encoder/blocks`` in
the reference and a list in ``encoder/layers`` in the port.  The input
is the JAX pytree with its leaves as numpy arrays (``jax.tree.map(
np.asarray, tree)``), so this module needs no JAX.  ``dense`` weights keep
their (din, dout) orientation.  bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses; they go
across as their uint16 bits, so every value is exact.

The reverse carrier (:func:`stack_params`, :func:`stack_state`,
:func:`state_to_jax`) stacks the port's layers back into the reference's
layout, for the train state's checkpoints (which either package restores)
and for gradient compression, whose scales are per stacked leaf.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import tree as T
from ..configs.base import ArchConfig


def to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    """One numpy leaf → a tensor that owns a copy of its bits.  bfloat16
    arrives as ``ml_dtypes.bfloat16`` (the reference's arrays) or as its
    bits in a ``np.dtype("V2")`` array (``np.load`` of one without
    ``ml_dtypes``)."""
    a = np.array(a, order="C")                  # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
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
        for k in ("embed", "final_norm", "unembed", "pos_embed")
        if k in params_np}
    out["layers"] = [_map(layer, conv)
                     for layer in unstack_layers(cfg, params_np)]
    if "encoder" in params_np:
        out["encoder"] = _map(_unstack_encoder(cfg, params_np["encoder"]),
                              conv)
    return out


def _unstack_encoder(cfg: ArchConfig, enc: Dict[str, Any]) -> Dict[str, Any]:
    """``{"blocks": stacked over the encoder's layers, "norm"}`` →
    ``{"layers": [one subtree per layer], "norm"}`` (leaves as they are)."""
    return {"layers": [_map(enc["blocks"], lambda a, i=i: a[i])
                       for i in range(cfg.encoder.num_layers)],
            "norm": enc["norm"]}


# ---------------------------------------------------------------------------
# The reverse carrier: the port's per-layer trees → the reference's stacked
# layout (params, and any tree shaped like them: AdamW moments, the error
# feedback residual), for checkpoints and compression that must see the
# reference's leaves.
# ---------------------------------------------------------------------------

def reference_path(cfg: ArchConfig, path: Tuple) -> Tuple[Tuple, Any]:
    """A port params path → (the reference's leaf path, the group index
    along its stacked axis, or None for an unstacked leaf).  ``("layers",
    i, *rest)`` maps to ``prefix{i}``, ``blocks/s{s}`` at group g, or
    ``tail{j}``; ``("encoder", "layers", i, *rest)`` to ``encoder/blocks``
    at index i; other paths are the reference's already."""
    if path[:2] == ("encoder", "layers"):
        return ("encoder", "blocks") + tuple(path[3:]), path[2]
    if not path or path[0] != "layers":
        return tuple(path), None
    i, rest = path[1], tuple(path[2:])
    n_pre, p = len(cfg.prefix), len(cfg.pattern)
    if i < n_pre:
        return (f"prefix{i}",) + rest, None
    j = i - n_pre
    if j < cfg.pattern_groups * p:
        g, s = divmod(j, p)
        return ("blocks", f"s{s}") + rest, g
    return (f"tail{j - cfg.pattern_groups * p}",) + rest, None


def stack_params(cfg: ArchConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params (or a tree shaped like them) → the reference's layout:
    each pattern slot's layers stacked along a leading group axis (a copy,
    on the leaves' device), prefix and tail layers as they are."""
    layers = params["layers"]
    n_pre, p, G = len(cfg.prefix), len(cfg.pattern), cfg.pattern_groups
    out: Dict[str, Any] = {k: v for k, v in params.items() if k != "layers"}
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"blocks": T.map(lambda *xs: torch.stack(xs),
                                          *enc["layers"]),
                          "norm": enc["norm"]}
    for i in range(n_pre):
        out[f"prefix{i}"] = layers[i]
    out["blocks"] = {
        f"s{s}": T.map(lambda *xs: torch.stack(xs),
                       *[layers[n_pre + g * p + s] for g in range(G)])
        for s in range(p)}
    for j in range(len(cfg.tail_specs)):
        out[f"tail{j}"] = layers[n_pre + G * p + j]
    return out


def unstack_params(cfg: ArchConfig, stacked: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`stack_params` for tensor leaves: one
    contiguous copy per layer."""
    names = [k for k in stacked if k == "blocks" or k.startswith("prefix")
             or k.startswith("tail")]
    out: Dict[str, Any] = {k: v for k, v in stacked.items() if k not in names}
    out["layers"] = [T.map(lambda a: a.clone(), layer)
                     for layer in unstack_layers(cfg, stacked)]
    if "encoder" in stacked:
        out["encoder"] = T.map(lambda a: a.clone(),
                               _unstack_encoder(cfg, stacked["encoder"]))
    return out


def stack_state(cfg: ArchConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """A train state (``{"params", "opt", ["ef"]}``, see
    ``launch/steps.py``) → the reference's layout: params, AdamW moments
    and the error-feedback residual stacked; the NamedTuples keep their
    fields, so checkpoint paths read ``opt/.m/blocks/s0/...`` as the
    reference's do."""
    out: Dict[str, Any] = {"params": stack_params(cfg, state["params"])}
    if "opt" in state:
        o = state["opt"]
        out["opt"] = type(o)(o.step, stack_params(cfg, o.m),
                             stack_params(cfg, o.v))
    if "ef" in state:
        out["ef"] = type(state["ef"])(stack_params(cfg,
                                                   state["ef"].residual))
    return out


def unstack_state(cfg: ArchConfig, stacked: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`stack_state` (tensor leaves); the optimizer
    and error-feedback states come back as the port's NamedTuples, whatever
    class held them (the reference's, carried as numpy, included)."""
    from ..optimizer.adamw import AdamWState
    from ..optimizer.compression import ErrorFeedbackState
    out: Dict[str, Any] = {"params": unstack_params(cfg, stacked["params"])}
    if "opt" in stacked:
        step, m, v = stacked["opt"]
        out["opt"] = AdamWState(step.clone(), unstack_params(cfg, m),
                                unstack_params(cfg, v))
    if "ef" in stacked:
        (residual,) = stacked["ef"]
        out["ef"] = ErrorFeedbackState(unstack_params(cfg, residual))
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor → a host numpy array; bfloat16 as its 16 bits in a
    ``np.dtype("V2")`` array, which is what ``np.save`` writes and
    ``np.load`` returns for the reference's ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def state_to_jax(cfg: ArchConfig, state: Dict[str, Any]) -> Dict[str, Any]:
    """A port train state (or ``{"params": ...}``) → the reference's
    stacked layout with numpy leaves (see :func:`to_numpy` for bfloat16)."""
    return T.map(to_numpy, stack_state(cfg, state))


def state_from_jax(cfg: ArchConfig, tree_np: Dict[str, Any],
                   device="cpu") -> Dict[str, Any]:
    """The reference's train state (numpy leaves; its ``AdamWState`` and
    ``ErrorFeedbackState``) → the port's on ``device``."""
    return unstack_state(cfg, T.map(lambda a: to_torch(np.asarray(a),
                                                       device), tree_np))
