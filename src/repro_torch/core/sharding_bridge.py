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
extent; a device may stand at several positions), a tuple :class:`P`, and
a :class:`NamedSharding` ``(mesh, spec)`` that compares by value.

:func:`device_put_dataset` places a stored dataset's ``(m, capacity, ...)``
columns on a mesh of any size as :class:`ShardedColumn`\\ s, the
counterpart of a ``jax.Array`` committed to ``NamedSharding(mesh,
P("data", None, ...))``: one tensor per mesh position, holding that
position's block of workers.  The column carries its sharding, which
:func:`sharding_of` reads.  Every column goes to the devices, whatever its
dtype: the port has no x64 hybrid that keeps 64-bit columns on the host.

One controller drives every shard, as one ``jax.Array`` spans the local
devices of one process: the store, its Autopilot tick and the serving
frontend's threads share one process, so a shard is a tensor on its own
device and a repartition copies rows between devices
(``data/device_repartition.sharded_repartition_dataset``).  A DTensor
would need one process per device, each tick decided on every rank at
once; the LM's SPMD layer keeps ``torch.distributed``
(``launch/mesh.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


def _data_axes(spec: P) -> Tuple[str, ...]:
    """The mesh axes a spec lays the leading axis over (none for P())."""
    first = spec[0] if len(spec) else None
    if first is None:
        return ()
    return tuple(first) if isinstance(first, tuple) else (first,)


def _block_of(mesh: Mesh, axes: Tuple[str, ...], idx: Tuple[int, ...]
              ) -> int:
    """The leading-axis block mesh position ``idx`` holds: its position
    along ``axes``, the first axis major (JAX's order)."""
    j = 0
    for a in axes:
        i = mesh.axis_names.index(a)
        j = j * mesh.devices.shape[i] + idx[i]
    return j


def _positions(sharding: NamedSharding) -> List[Tuple[Tuple[int, ...], int]]:
    """(mesh position, block) of every position of the mesh: a replicated
    spec (P()) holds its one block at each."""
    mesh = sharding.mesh
    axes = _data_axes(sharding.spec)
    return [(idx, _block_of(mesh, axes, idx))
            for idx in np.ndindex(mesh.devices.shape)]


def _first_device_mesh(mesh: Mesh) -> Mesh:
    """``mesh``'s first device alone, under the same axis names — where a
    column put on the mesh unsharded lives (the reference's
    ``jax.device_put`` puts it on the default device)."""
    return Mesh(np.array([mesh.devices.flat[0]], dtype=object).reshape(
        (1,) * mesh.devices.ndim), mesh.axis_names)


def block_devices(sharding: NamedSharding) -> List[torch.device]:
    """The device of the first mesh position holding each block, in block
    order: where a repartition builds the block before it is copied to the
    block's other positions."""
    first: Dict[int, torch.device] = {}
    for idx, j in _positions(sharding):
        first.setdefault(j, sharding.mesh.devices[idx])
    return [first[j] for j in range(len(first))]


#: whole-column reads of sharded columns since :func:`reset_whole_reads`:
#: a column assembled in one place — to numpy, onto one device, gathered
#: to the host, or flattened onto one device by a repartition that cannot
#: go shard to shard
WHOLE_READS: Dict[str, int] = {"columns": 0}
_READS_LOCK = threading.Lock()


def count_whole_read() -> None:
    with _READS_LOCK:
        WHOLE_READS["columns"] += 1


def reset_whole_reads() -> None:
    with _READS_LOCK:
        WHOLE_READS["columns"] = 0


class ShardedColumn:
    """One stored column spread over a mesh — where the reference holds a
    ``jax.Array`` committed to a :class:`NamedSharding`.

    The leading (worker) axis is cut into one block per position along the
    spec's data axes, in rank order, and block ``j`` is held as a tensor on
    every mesh device at data position ``j``: replicated over the other
    axes, as ``P(data, None)`` replicates it over "model"; ``P()`` holds
    the whole column at every position.  Where a mesh names one device at
    several positions, those positions share one tensor.  Columns are
    immutable once placed, so a block may be a view of the tensor it was
    placed from.

    :meth:`shards` is the counterpart of ``addressable_shards`` with
    ``.index``; :meth:`numpy` and :meth:`to_device` read the whole column
    in worker order, and count the read (:data:`WHOLE_READS`)."""

    def __init__(self, sharding: NamedSharding,
                 blocks: Sequence[torch.Tensor]):
        positions = _positions(sharding)
        n_blocks = 1 + max(j for _, j in positions)
        if len(blocks) != n_blocks:
            raise ValueError(f"{len(blocks)} blocks for a sharding of "
                             f"{n_blocks}")
        self.sharding = sharding
        self.dtype = blocks[0].dtype
        rows = [int(b.shape[0]) for b in blocks]
        starts = np.concatenate([[0], np.cumsum(rows)]).astype(int)
        self.shape = (int(starts[-1]),) + tuple(blocks[0].shape[1:])
        held: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        first: Dict[int, Tuple[slice, torch.Tensor]] = {}
        self._shards = []
        for idx, j in positions:
            dev = sharding.mesh.devices[idx]
            t = held.get((j, dev))
            if t is None:
                t = held[(j, dev)] = blocks[j].to(dev)
            sl = slice(int(starts[j]), int(starts[j + 1]))
            first.setdefault(j, (sl, t))
            self._shards.append((idx, dev, sl, t))
        self._blocks = [first[j] for j in range(n_blocks)]

    def shards(self) -> Iterator[Tuple[Tuple[int, ...], torch.device, slice,
                                       torch.Tensor]]:
        """(mesh index, device, leading-axis slice, tensor) of every
        position that holds a block."""
        return iter(self._shards)

    def blocks(self) -> List[Tuple[slice, torch.Tensor]]:
        """(leading-axis slice, tensor) of each block once, in block
        order, from the first position that holds it."""
        return list(self._blocks)

    @property
    def devices(self) -> List[torch.device]:
        return list(dict.fromkeys(d for _, d, _, _ in self._shards))

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(np.prod(self.shape))

    def element_size(self) -> int:
        return torch.empty(0, dtype=self.dtype).element_size()

    @property
    def nbytes(self) -> int:
        """Bytes of the logical column, replicas not counted (a jax
        array's ``nbytes``)."""
        return self.numel() * self.element_size()

    def numpy(self) -> np.ndarray:
        """The whole column on the host, in worker order (counted)."""
        count_whole_read()
        return np.concatenate([t.cpu().numpy() for _, t in self.blocks()])

    def to_device(self, device) -> torch.Tensor:
        """The whole column as one tensor on ``device`` (counted)."""
        count_whole_read()
        return torch.cat([t.to(device) for _, t in self.blocks()])

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedColumn(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec!r}, {len(self._shards)} shards)")


def _rows(v, a: int, b: int, device: torch.device) -> torch.Tensor:
    """Rows ``[a, b)`` of a column's leading axis as a tensor on
    ``device``: a sharded column's are copied from the blocks that hold
    them, device to device."""
    if isinstance(v, ShardedColumn):
        parts = [t[max(a, sl.start) - sl.start:min(b, sl.stop) - sl.start]
                 .to(device) for sl, t in v.blocks()
                 if sl.start < b and a < sl.stop]
        if not parts:
            return v.blocks()[0][1][:0].to(device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    if isinstance(v, torch.Tensor):
        return v[a:b].to(device)
    return torch.from_numpy(np.array(v[a:b])).to(device)


def device_put_dataset(mesh: Mesh, ds,
                       data_axes: Tuple[str, ...] = ("data",)):
    """Place a StoredDataset's padded columns on ``mesh``, worker axis
    sharded — the persistent partitioning made physical (DESIGN §5).

    Returns a new ``StoredDataset`` whose columns are
    :class:`ShardedColumn`\\ s committed to ``sharding_for(mesh,
    ds.partitioner, data_axes)``: each mesh position holds its block of
    ``m / extent`` workers.  Columns already on devices (a device write, a
    d2d repartition's output, a placed dataset) move device to device.  The
    worker count ``m`` must divide evenly over the data axes, checked
    before anything is placed.  A bucketed (``capacity_map``) layout has no
    leading worker axis, so its columns are placed unsharded (``P()``) on
    the mesh's first device (:func:`_first_device_mesh`), as the reference
    places them on its default device; a bucketed column already placed
    keeps its placement, as ``jax.device_put`` keeps an array's."""
    from ..data.partition_store import StoredDataset
    extent = int(np.prod([mesh.shape[a] for a in data_axes]))
    if ds.num_workers % extent:
        raise ValueError(
            f"m={ds.num_workers} not divisible by mesh data extent {extent}")
    bucketed = ds.capacity_map is not None
    cols = {}
    for k, v in ds.columns.items():
        if bucketed and isinstance(v, ShardedColumn):
            cols[k] = v
            continue
        sh = (NamedSharding(_first_device_mesh(mesh), P()) if bucketed else
              sharding_for(mesh, ds.partitioner, data_axes,
                           extra_dims=len(v.shape) - 2))
        devs = block_devices(sh)
        step = v.shape[0] // len(devs)
        cols[k] = ShardedColumn(sh, [_rows(v, j * step, (j + 1) * step, d)
                                     for j, d in enumerate(devs)])
    return StoredDataset(name=ds.name, columns=cols, counts=ds.counts,
                         partitioner=ds.partitioner, num_rows=ds.num_rows,
                         nbytes=ds.nbytes, created_at=ds.created_at,
                         generation=ds.generation,
                         capacity_map=ds.capacity_map)


def sharding_of(ds, column: str) -> Optional[NamedSharding]:
    """The sharding of ``column`` while it is placed on a mesh (a
    :class:`ShardedColumn`); else None (a jax array carries its
    ``.sharding``)."""
    col = ds.columns.get(column)
    return col.sharding if isinstance(col, ShardedColumn) else None
