"""Sharding rules: param/batch/cache partition specs for every arch × mesh,
the port of the JAX package's ``launch/shardings.py``.

This is the *default persistent partitioning* of the model state — the
baseline the Lachesis sharding advisor (``core/sharding_advisor.py``)
starts from.  Rules are path-based over the params tree:

  column-parallel (out-dim over "model"): wq wk wv wq_a wq_b wkv_b in_proj
      in_x in_gate w_r w_i w_in w_gate, ssd/rglru conv channels
  row-parallel   (in-dim over "model"):  wo out out_proj w_out
  expert-parallel: MoE (E, ·, ·) tensors sharded on E over "model"
  vocab-parallel: embedding / unembedding tables on dim 0
  replicated: norms, routers, tiny vectors (Λ, A_log, D, dt_bias)

Small models (< 1B params) use pure data parallelism: params replicated,
batch sharded over every mesh axis that divides it.

The reference's rules read its stacked trees: a pattern slot's layers
share one leaf with a leading group axis (``blocks/s{s}/...``), as do an
encoder's (``encoder/blocks/...``) and the cross-attention caches
(``cross/k``).  The port keeps one subtree per layer.  Each port leaf is
therefore mapped to the reference's leaf (``models/convert.reference_
path``), the reference's rule is applied to that leaf's shape (the port's
with a group axis in front where the reference stacks), and the group
axis's entry — never sharded — is dropped.  There is one rule table, the
reference's, kept here as this package's own copy.

Specs are :class:`~..core.sharding_bridge.P`; :func:`to_placements` turns
one into ``DTensor`` placements on a ``DeviceMesh`` (the counterpart of the
reference's ``to_named``) and :func:`distribute` places a tree.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import tree as T
from ..configs.base import ArchConfig, ShapeSpec
from ..core.sharding_bridge import P
from ..models.convert import reference_path
from .mesh import axis_names, axis_sizes

COL_PARENTS = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_b", "in_proj",
               "in_x", "in_gate", "w_r", "w_i", "w_in", "w_gate"}
ROW_PARENTS = {"wo", "out", "out_proj", "w_out"}
REPLICATED_PARENTS = {"wkv_a", "router"}   # latent proj small → cache replicated
TINY_LEAVES = {"lam", "A_log", "D", "dt_bias", "scale", "bias", "conv_b"}


def small_model(cfg: ArchConfig, threshold: float = 1e9) -> bool:
    return cfg.param_count() < threshold


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


# ---------------------------------------------------------------------------
# Port leaves → the reference's leaves
# ---------------------------------------------------------------------------

def _reference_leaf(cfg: ArchConfig, path: Tuple, cache: bool
                    ) -> Tuple[List[str], bool]:
    """(the reference's path parts, whether the reference stacks the leaf)
    for a port params path, or with ``cache`` a port cache path
    ``(layer, *rest)``: a layer's cross K/V is the reference's
    ``cross/{k,v}``, stacked over every layer."""
    if cache:
        if "cross" in path:
            return ["cross", str(path[-1])], True
        path = ("layers",) + tuple(path)
    ref, group = reference_path(cfg, tuple(path))
    return [str(p) for p in ref], group is not None


def _on_reference_leaves(cfg: ArchConfig, tree: Any,
                         rule: Callable[[List[str], Tuple[int, ...]], P],
                         cache: bool = False) -> Any:
    """``rule(reference parts, reference shape)`` for every leaf of
    ``tree``, as a tree of specs for the port's leaves."""
    def fn(path, leaf):
        parts, stacked = _reference_leaf(cfg, path, cache)
        shape = ((1,) if stacked else ()) + tuple(leaf.shape)
        spec = rule(parts, shape)
        if not stacked:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        assert entries[0] is None, f"{parts}: the group axis is sharded"
        return P(*entries[1:])
    return T.map_with_path(fn, tree)


def _strip_slots(parts: List[str]) -> List[str]:
    return [p for p in parts if not (p.startswith("s") and p[1:].isdigit())]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _base_param_rule(parts, shape, model: int) -> P:
    """Rule for an UNstacked param leaf."""
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    nd = len(shape)

    if leaf in TINY_LEAVES or parent.startswith("ln") or \
            parent in ("final_norm", "norm", "q_norm", "k_norm", "kv_norm"):
        return P(*([None] * nd))
    if leaf == "table":                                   # embed / unembed
        return P("model" if _div(shape[0], model) else None, None)
    if leaf == "pos_embed" or parts[-1] == "pos_embed":
        return P(None, None)
    if parent in REPLICATED_PARENTS:
        return P(*([None] * nd))
    if leaf == "conv_w" and nd == 2:                      # (W, C) depthwise
        return P(None, "model" if _div(shape[1], model) else None)
    if nd == 3 and leaf in ("w_in", "w_gate", "w_out"):   # MoE experts (E,·,·)
        return P("model" if _div(shape[0], model) else None, None, None)
    if leaf == "w" and parent in COL_PARENTS:
        return P(None, "model" if _div(shape[1], model) else None)
    if leaf == "w" and parent in ROW_PARENTS:
        return P("model" if _div(shape[0], model) else None, None)
    if leaf == "b":
        if parent in COL_PARENTS:
            return P("model" if _div(shape[0], model) else None)
        return P(None)
    return P(*([None] * nd))                              # default: replicate


def param_pspecs(cfg: ArchConfig, params_struct: Any, mesh) -> Any:
    """Spec tree matching ``params_struct`` (the port's params)."""
    model = axis_sizes(mesh).get("model", 1)
    dp_only = small_model(cfg)

    def rule(parts, shape):
        if dp_only:
            # pure DP: replicate everything (advisor-selected for <1B)
            return P(*([None] * len(shape)))
        stacked = parts[0] in ("blocks", "encoder") and "blocks" in parts[:2]
        base_parts = _strip_slots(parts)
        if stacked:
            return P(None, *_base_param_rule(base_parts, shape[1:], model))
        return _base_param_rule(base_parts, shape, model)

    return _on_reference_leaves(cfg, params_struct, rule)


# ---------------------------------------------------------------------------
# Batch
# ---------------------------------------------------------------------------

def batch_axes_for(B: int, cfg: ArchConfig, mesh) -> Tuple[str, ...]:
    """Largest mesh-axis prefix whose product divides B.  Small models also
    spread batch over the model axis (pure DP over the whole pod)."""
    sizes = axis_sizes(mesh)
    names = [a for a in axis_names(mesh) if a != "model"]
    if small_model(cfg):
        names = names + ["model"]
    while names:
        prod = math.prod(sizes[a] for a in names)
        if _div(B, prod):
            return tuple(names)
        names.pop()                                       # drop last axis
    return ()


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                 batch_override: Optional[int] = None) -> Dict[str, P]:
    B = batch_override or shape.global_batch
    dp = batch_axes_for(B, cfg, mesh)
    # no axis divides B: replicated (JAX reads the reference's () so)
    dp_spec = (dp if len(dp) != 1 else dp[0]) if dp else None
    specs = {"tokens": P(dp_spec, None), "labels": P(dp_spec, None)}
    if cfg.encoder is not None:
        specs["frames"] = P(dp_spec, None, None)
    return specs


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _cache_leaf_rule(parts, shape, dp: Tuple[str, ...], dp_size: int,
                     model: int) -> P:
    leaf = parts[-1]
    nd = len(shape)
    dp_spec: Any = (dp if len(dp) != 1 else dp[0]) if dp else None

    # strip stacked leading dims (blocks G axis / cross layer axis)
    lead = 1 if parts[0] in ("blocks", "cross") else 0
    core = shape[lead:]
    pre = [None] * lead

    def b_or_l(B, Lc):
        """Shard batch over dp when it divides; else shard the cache's
        sequence axis (ring/sequence-parallel KV for batch-1 long context)."""
        if dp and _div(B, dp_size):
            return dp_spec, None
        if dp and Lc is not None and _div(Lc, dp_size):
            return None, dp_spec
        return None, None

    if leaf in ("k", "v"):                                # (B, L, KV, hd)
        B, Lc, KV, hd = core
        b_ax, l_ax = b_or_l(B, Lc)
        if _div(KV, model):
            return P(*pre, b_ax, l_ax, "model", None)
        if _div(hd, model):
            return P(*pre, b_ax, l_ax, None, "model")
        return P(*pre, b_ax, l_ax, None, None)
    if leaf == "ckv":                                     # (B, L, R)
        B, Lc, R = core
        b_ax, l_ax = b_or_l(B, Lc)
        return P(*pre, b_ax, l_ax, "model" if _div(R, model) else None)
    if leaf == "krope":
        B, Lc, _ = core
        b_ax, l_ax = b_or_l(B, Lc)
        return P(*pre, b_ax, l_ax, None)
    if leaf == "h" and len(core) == 4:                    # ssd (B,H,P,N)
        B, H, Pd, N = core
        b_ax, _ = b_or_l(B, None)
        return P(*pre, b_ax, "model" if _div(H, model) else None, None, None)
    if leaf == "h" and len(core) == 2:                    # rglru (B,W)
        B, W = core
        b_ax, _ = b_or_l(B, None)
        return P(*pre, b_ax, "model" if _div(W, model) else None)
    if leaf == "conv":                                    # (B, W-1, C)
        B, _, C = core
        b_ax, _ = b_or_l(B, None)
        return P(*pre, b_ax, None, "model" if _div(C, model) else None)
    return P(*([None] * nd))


def cache_pspecs(cfg: ArchConfig, cache_struct: Any, B: int,
                 mesh, seq_shard_model: bool = False) -> Any:
    """Spec tree matching the port's per-layer cache list.
    ``seq_shard_model``: additionally shard the cache SEQUENCE axis over
    "model" (flash-decode style — each model rank attends over L/mp keys
    and the softmax combines across ranks).  §Perf decode hillclimb knob."""
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = tuple(a for a in axis_names(mesh) if a != "model")
    if small_model(cfg):
        dp = dp + ("model",)
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    model_eff = 0 if small_model(cfg) else model   # 0 ⇒ never model-shard

    def rule(parts, shape):
        parts = _strip_slots(parts)
        spec = _cache_leaf_rule(parts, shape, dp, dp_size, model_eff)
        if seq_shard_model and parts[-1] in ("k", "v", "ckv", "krope"):
            lead = 1 if parts[0] in ("blocks", "cross") else 0
            seq_dim = lead + 1
            Ld = shape[seq_dim]
            if Ld % max(model, 1) == 0 and model > 1:
                # move the model axis from heads/hd onto the sequence dim
                entries = [None if e == "model" else e for e in list(spec)]
                entries[seq_dim] = "model"
                spec = P(*entries)
        return spec

    return _on_reference_leaves(cfg, cache_struct, rule, cache=True)


# ---------------------------------------------------------------------------
# ZeRO-1 / FSDP
# ---------------------------------------------------------------------------

def shard_over_dp(cfg: ArchConfig, param_specs: Any, params_struct: Any,
                  mesh, skip_stacked_dim: bool = True) -> Any:
    """Additionally shard each tensor over the DP axes along the first
    unsharded, divisible dimension.  Used for (a) ZeRO-1 optimizer moments
    and (b) FSDP parameter sharding of ≥50B models.  The reference skips
    its scanned layer-stack axis (dim 0 under blocks/ and encoder/); a
    port leaf has no such axis, and the reference's leaf is read in its
    place, so the choice is the reference's (``cfg`` finds that leaf)."""
    sizes = axis_sizes(mesh)
    dp = tuple(a for a in axis_names(mesh) if a != "model")
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    dp_spec: Any = dp if len(dp) != 1 else (dp[0] if dp else None)

    def rule(path, leaf, spec):
        if dp_size <= 1:
            return spec
        parts, stacked = _reference_leaf(cfg, path, cache=False)
        shape = ((1,) if stacked else ()) + tuple(leaf.shape)
        entries = ([None] if stacked else []) + list(spec)
        entries += [None] * (len(shape) - len(entries))
        used = {a for e in entries if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        if not used & set(dp):
            ref_stacked = parts[0] in ("blocks", "encoder") and \
                skip_stacked_dim
            for i in range(1 if ref_stacked else 0, len(entries)):
                if entries[i] is None and shape[i] % dp_size == 0:
                    entries[i] = dp_spec
                    break
        if stacked:
            assert entries[0] is None, f"{parts}: the group axis is sharded"
            entries = entries[1:]
        return P(*entries)

    new = [rule(path, leaf, spec) for (path, leaf), spec in
           zip(T.flatten_with_paths(params_struct), spec_leaves(param_specs))]
    return T.unflatten(params_struct, new)


FSDP_THRESHOLD = 50e9     # params ≥ 50B: shard params over DP axes too


def train_state_pspecs(cfg: ArchConfig, state_struct: Any, mesh,
                       zero1: bool = True,
                       fsdp: Optional[bool] = None) -> Any:
    """Specs for {"params", "opt": AdamWState(step, m, v)}."""
    params = state_struct["params"]
    pspec = param_pspecs(cfg, params, mesh)
    fsdp = (cfg.param_count() >= FSDP_THRESHOLD) if fsdp is None else fsdp
    if fsdp:
        pspec = shard_over_dp(cfg, pspec, params, mesh)
    mspec = pspec
    if zero1 and not small_model(cfg):
        mspec = shard_over_dp(cfg, pspec, params, mesh)
    opt = state_struct["opt"]
    return {"params": pspec,
            "opt": type(opt)(step=P(), m=mspec, v=mspec)}


# ---------------------------------------------------------------------------
# Specs → DTensor placements
# ---------------------------------------------------------------------------

def spec_leaves(specs: Any) -> List[P]:
    """The specs of a spec tree in the order :func:`..tree.leaves` visits
    the tree it matches (a :class:`P` is a leaf here, not a tuple)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for child in specs for s in spec_leaves(child)]


def to_placements(mesh, spec: P) -> list:
    """``spec`` as one ``DTensor`` placement per mesh axis: ``Shard(d)``
    for the axes that tensor dim ``d`` names, ``Replicate()`` for the
    rest.  A dim over several axes names them in mesh order, as DTensor
    splits a dim over its mesh axes left to right."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    placements: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {dim} names {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            placements[i] = Shard(dim)
    return placements


def distribute(mesh, tree: Any, specs: Any) -> Any:
    """Every tensor of ``tree`` as a ``DTensor`` on ``mesh`` laid out as
    its spec in ``specs`` (a tree of the same structure)."""
    from torch.distributed.tensor import distribute_tensor
    it = iter(spec_leaves(specs))
    return T.map(lambda t: distribute_tensor(
        t, mesh, to_placements(mesh, next(it))), tree)


def dtensor_zeros(mesh, struct: Any, specs: Any, device) -> Any:
    """A zero ``DTensor`` for every leaf of ``struct`` (leaves with
    ``.shape`` and ``.dtype``) laid out as its spec, each rank allocating
    only its shard on ``device``; every sharded dim must divide."""
    from torch.distributed.tensor import DTensor, Shard
    sizes = list(mesh.shape)
    it = iter(spec_leaves(specs))

    def make(leaf):
        placements = to_placements(mesh, next(it))
        local = list(leaf.shape)
        for size, pl in zip(sizes, placements):
            if isinstance(pl, Shard):
                if local[pl.dim] % size:
                    raise ValueError(f"{tuple(leaf.shape)}: dim {pl.dim} "
                                     f"does not divide over {size} ranks")
                local[pl.dim] //= size
        return DTensor.from_local(
            torch.zeros(local, dtype=leaf.dtype, device=device), mesh,
            placements, run_check=False)
    return T.map(make, struct)


def local_bytes(tree: Any) -> int:
    """Bytes one rank holds of a tree of DTensors (plain tensors
    count whole)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in T.leaves(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total

