"""The kernels' backward passes on DTensors, shard by shard.

A kernel's custom op runs on each rank's shards (its sharding rule keeps
the inputs batch- or head-sharded, or replicated), and each (batch row,
head) of attention and of the SSD scan is independent of the others, so
the plain twin's VJP is exact on the same shards.  Run on the global
DTensors instead, the twin's ops would be placed one by one and its
float32 score matrices gathered whole; so the backward takes each rank's
shards in the forward's layout, runs the VJP on them, and wraps the
gradients back, partial over the mesh axes where an input was replicated
but the work split (its gradient sums over the shards).

:func:`pad_zeros` pads with zeros so that a ``DTensor``'s layout carries
through; the flash-attention dispatcher pads head dims with it, and the
models pad sequences and widths.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..pjit_utils import mesh_of


def to_locals(ts: Sequence, mesh, placements: Sequence) -> List:
    """Each ``DTensor`` laid out as its placements, as its local shard."""
    return [t.redistribute(mesh, pl).to_local() if t is not None else None
            for t, pl in zip(ts, placements)]


def from_locals(ts: Sequence, mesh, placements: Sequence) -> List:
    """Local gradients as DTensors of the given placements."""
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(t, mesh, pl, run_check=False)
            if t is not None else None for t, pl in zip(ts, placements)]


def partial_where_replicated(inputs: Sequence, split: Sequence) -> List:
    """Gradient placements: an input's own, with ``Partial()`` on the mesh
    axes where it is replicated but ``split`` (the output's placements)
    divides the work."""
    from torch.distributed.tensor import Partial, Replicate
    return [[Partial() if p == Replicate() and s != Replicate() else p
             for p, s in zip(pl, split)] for pl in inputs]


def pad_zeros(x: torch.Tensor, pad) -> torch.Tensor:
    """``F.pad(x, pad)`` with zeros.  A DTensor is padded by concatenating
    zero slices of itself along each padded dim, so its layout carries
    through (some torch versions' DTensor fails to redistribute for
    ``pad``); the values are the same."""
    if mesh_of(x) is None:
        return F.pad(x, pad)
    for k in range(len(pad) // 2):
        dim = x.dim() - 1 - k
        parts = [_zeros_along(x, dim, pad[2 * k]), x,
                 _zeros_along(x, dim, pad[2 * k + 1])]
        parts = [t for t in parts if t is not None]
        if len(parts) > 1:
            x = torch.cat(parts, dim=dim)
    return x


def _zeros_along(x: torch.Tensor, dim: int, n: int):
    if not n:
        return None
    z = torch.zeros_like(x.narrow(dim, 0, min(n, x.shape[dim])))
    while z.shape[dim] < n:
        z = torch.cat([z, z], dim=dim)
    return z.narrow(dim, 0, n)
