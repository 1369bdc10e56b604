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
"""

from __future__ import annotations

from typing import List, Sequence


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
