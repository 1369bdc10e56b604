"""SPMD helpers usable from model code without importing launch/: the port
of the JAX package's ``pjit_utils.py``.

``constrain`` applies a sharding constraint only when the process has
opted into SPMD mode (the dry run, a distributed step); single-device runs
keep it off and need no mesh.  Where the reference hands XLA a
``with_sharding_constraint``, the port redistributes a ``DTensor`` to the
placements the spec names on the tensor's own mesh
(:func:`..launch.shardings.to_placements`); a plain tensor passes through.
"""

from __future__ import annotations

_SPMD = False


def mesh_of(t):
    """The ``DeviceMesh`` of a ``DTensor``; None for anything else."""
    from torch.distributed.tensor import DTensor
    return t.device_mesh if isinstance(t, DTensor) else None


def shard_index(mesh, axes) -> int:
    """This rank's index among the shards of a dim split over the mesh
    ``axes`` (DTensor splits a dim over its axes left to right)."""
    idx = 0
    for i in axes:
        idx = idx * mesh.shape[i] + mesh.get_local_rank(i)
    return idx


def enable_spmd(flag: bool = True) -> None:
    global _SPMD
    _SPMD = flag


def spmd_enabled() -> bool:
    return _SPMD


def constrain(x, spec):
    """``x`` laid out as ``spec`` (a :class:`..core.sharding_bridge.P`)
    when SPMD is on and ``x`` is a ``DTensor``; else ``x`` itself."""
    if not _SPMD:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from .launch.shardings import to_placements
    return x.redistribute(x.device_mesh, to_placements(x.device_mesh, spec))


def use_param(w):
    """A parameter as a step uses it: under SPMD, a ``DTensor`` sharded
    over the data axes at rest (FSDP) is all-gathered over them first and
    keeps its "model" sharding; anything else is ``w`` itself.  XLA
    gathers FSDP weights so; DTensor, left to itself, may move the
    activations instead (an all-to-all onto the contracting dim)."""
    if not _SPMD:
        return w
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    placements = [pl if n == "model" else Replicate()
                  for n, pl in zip(names, w.placements)]
    if list(w.placements) == placements:
        return w
    return w.redistribute(w.device_mesh, placements)


def constrain_batch_only(x):
    """``x`` (B, ...) with the batch dim's sharding kept and every other dim
    replicated, when SPMD is on and ``x`` is a ``DTensor``; else ``x``.
    The model pins its residual stream so after each residual add — the
    Megatron layout XLA's propagation settles on under the reference's
    rules (the row-parallel partial sums reduced, the hidden dim whole),
    where DTensor, placing op by op, can leave the hidden dim split over
    "model" and then gather the next layer's weights instead — and MLA's
    cached latent before it is expanded to K and V (gathering the latent
    costs 1/H of reducing the expanded K and V)."""
    if not _SPMD:
        return x
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    from .core.sharding_bridge import P
    names = x.device_mesh.mesh_dim_names
    axes = tuple(a for a, pl in zip(names, x.placements) if pl == Shard(0))
    batch = (axes if len(axes) > 1 else axes[0]) if axes else None
    return constrain(x, P(batch, *([None] * (x.dim() - 1))))


def spmd_cache(cfg, B: int, Lc: int, tokens):
    """The zero cache a prefill starts from (``models/transformer.
    init_cache``).  When SPMD is on and ``tokens`` is a ``DTensor``, each
    leaf is a ``DTensor`` laid out by the cache rules
    (``launch/shardings.cache_pspecs``) on the tokens' mesh, made shard by
    shard: no rank allocates the global cache.  (Under XLA the reference's
    prefill leaves this layout to the compiler.)"""
    from .models.transformer import ShapeDtype, init_cache
    if _SPMD:
        from torch.distributed.tensor import DTensor
        if isinstance(tokens, DTensor):
            from .launch.shardings import cache_pspecs, dtensor_zeros
            mesh = tokens.device_mesh
            struct = init_cache(cfg, B, Lc, zeros=ShapeDtype)
            return dtensor_zeros(mesh, struct,
                                 cache_pspecs(cfg, struct, B, mesh),
                                 tokens.device)
    return init_cache(cfg, B, Lc, tokens.device)
