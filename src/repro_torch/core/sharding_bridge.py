"""Bridge: Lachesis partitionings ⇄ device placements.

The port of the JAX package's ``core/sharding_bridge.py``.  A persistent
partitioning over ``m`` workers maps onto a device mesh as a
:class:`NamedSharding` whose leading (worker) axis is laid out over the
data axes; *match ⇒ elide-shuffle* becomes: if a consumer's required
:class:`P` equals the stored one, no resharding collective is needed.

Torch has no mesh, partition spec or named sharding outside
``torch.distributed``, so this module defines small plain types with the
JAX ones' behaviour where the store uses it: a :class:`Mesh` of local
``torch.device``\\ s with axis names (``.shape`` maps each axis name to its
extent), a tuple :class:`P`, and a :class:`NamedSharding` ``(mesh, spec)``
that compares by value.

:func:`device_put_dataset` places a stored dataset's ``(m, capacity, ...)``
columns on the mesh and records the placement on the dataset, where
:func:`sharding_of` reads it back (a jax array carries its ``.sharding``).
Every column goes to the device, whatever its dtype: the port has no x64
hybrid that keeps 64-bit columns on the host.  A placement over more than
one device is refused with a ``ValueError``: one torch tensor cannot span
devices without ``torch.distributed`` (ROADMAP, multi-card mesh placement).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .partitioner import PartitionerCandidate


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current>``: the device a tensor moved there
    reports."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of local devices with one name per axis (JAX's ``Mesh``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = _indexed(torch.device(given[idx]))
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes "
                             f"{self.axis_names}")
        self.devices = arr

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


class P(tuple):
    """A partition spec: one entry per array dim, each a mesh axis name, a
    tuple of them, or None (replicated) — JAX's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: P


def sharding_for(mesh: Mesh, candidate: Optional[PartitionerCandidate],
                 data_axes: Tuple[str, ...] = ("data",),
                 extra_dims: int = 0) -> NamedSharding:
    """Sharding of a stored dataset's ``(m, capacity, ...)`` layout: the
    worker axis over the data mesh axes, the rest replicated.  Keyed, rr
    and random partitionings differ in which rows go to which worker (the
    partitioner), not in the sharding."""
    spec = P(data_axes if len(data_axes) > 1 else data_axes[0],
             *([None] * (1 + extra_dims)))
    return NamedSharding(mesh, spec)


def specs_match(a: P, b: P) -> bool:
    """Structural spec equality modulo trailing Nones — the sharding-level
    analogue of Alg. 4's signature equality."""
    la, lb = list(a), list(b)
    n = max(len(la), len(lb))
    la += [None] * (n - len(la))
    lb += [None] * (n - len(lb))
    return la == lb


def would_elide_collective(stored: P, required: P) -> bool:
    """True ⇒ consuming the operand needs no resharding collective."""
    return specs_match(stored, required)


def _mesh_size(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def device_put_dataset(mesh: Mesh, ds,
                       data_axes: Tuple[str, ...] = ("data",)):
    """Place a StoredDataset's padded columns on ``mesh``, worker axis
    sharded — the persistent partitioning made physical (DESIGN §5).

    Returns a new ``StoredDataset`` whose columns are tensors on the mesh's
    device (moved device to device where they already are tensors) and
    whose ``placement`` records each column's :class:`NamedSharding`.  The
    worker count ``m`` must divide evenly over the data axes, checked
    before anything is placed.  A bucketed (``capacity_map``) layout has no
    leading worker axis, so its columns are placed unsharded (``P()``), as
    the reference places them."""
    from ..data.partition_store import StoredDataset
    extent = int(np.prod([mesh.shape[a] for a in data_axes]))
    if ds.num_workers % extent:
        raise ValueError(
            f"m={ds.num_workers} not divisible by mesh data extent {extent}")
    if _mesh_size(mesh) != 1:
        raise ValueError(
            f"a mesh of {_mesh_size(mesh)} devices: a torch tensor lives on "
            "one device, and spreading a column's worker axis over several "
            "needs torch.distributed, which this port does not use; place "
            "on a one-device mesh")
    device = mesh.devices.flat[0]
    bucketed = ds.capacity_map is not None
    cols, placement = {}, {}
    for k, v in ds.columns.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        cols[k] = t.to(device)
        placement[k] = (NamedSharding(mesh, P()) if bucketed else
                        sharding_for(mesh, ds.partitioner, data_axes,
                                     extra_dims=t.dim() - 2))
    return StoredDataset(name=ds.name, columns=cols, counts=ds.counts,
                         partitioner=ds.partitioner, num_rows=ds.num_rows,
                         nbytes=ds.nbytes, created_at=ds.created_at,
                         generation=ds.generation,
                         capacity_map=ds.capacity_map, placement=placement)


def sharding_of(ds, column: str) -> Optional[NamedSharding]:
    """The placement :func:`device_put_dataset` recorded for ``column``,
    while the column is still a tensor on the mesh's device; else None."""
    sh = (ds.placement or {}).get(column)
    col = ds.columns.get(column)
    if sh is None or not isinstance(col, torch.Tensor) \
            or col.device != sh.mesh.devices.flat[0]:
        return None
    return sh
