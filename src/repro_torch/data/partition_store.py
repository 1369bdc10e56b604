"""Partitioned in-memory storage — the Pangea-storage analogue (paper §4).

A :class:`PartitionStore` holds named columnar datasets laid out across ``m``
logical workers.  The layout is the *persistent partitioning*: column arrays
are shaped ``(m, capacity, ...)`` with a per-worker ``counts`` vector, so a
consumer whose desired partitioner matches the stored one operates strictly
worker-locally (no shuffle).

Padded layout (DESIGN §2): objects → fixed-capacity padded rows; skew shows
up as padding waste, penalized by the ``key_distribution`` feature.

Backends (DESIGN §5): ``backend="device"`` (the default) holds columns as
torch tensors on the store's device — CUDA unless the caller asks for the
CPU — dispatching through the cached single-pass shuffle plans (hash →
counting-sort → packed scatter) and repartitioning device-to-device;
``backend="host"`` dispatches with numpy (one vectorized counting-sort
placement per write).

Only the in-memory store is ported so far: the durable tier (``root=``,
``memory_budget_bytes=``) and the cluster tier (``cluster=``) raise
``NotImplementedError``.

:func:`import_layout` and :func:`export_layout` carry a stored layout across
as numpy arrays (the port's counterpart of carried weights: this system's
state is its stored layout).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.backends import resolve_backend, resolve_device
from ..core.ir import to_numpy
from ..core.partitioner import (HASH, PartitionerCandidate, RANDOM,
                                ROUND_ROBIN)
from ..obs.tracer import span as _span
from .capacity import CapacityMap, plan_capacity_map, valid_slot_index
from .device_repartition import (device_repartition_dataset,
                                 device_scatter_padded,
                                 host_counting_sort_dest, shuffle_pids)


Columns = Dict[str, Any]

#: write_log entries retained verbatim; older entries fold into the
#: monotone ``write_totals`` aggregates
DEFAULT_WRITE_LOG_CAP = 256

#: where the tiers this store does not have yet are planned
_DURABLE_ITEM = ("the durable tier is not ported yet (ROADMAP Queue 1: "
                 "data/storage/)")
_CLUSTER_ITEM = ("the cluster tier is not ported yet (ROADMAP Queue 1: "
                 "service/, obs/, cluster/, runtime/)")


class RetiredGenerationError(KeyError):
    """A specific, still-retained generation was requested but has left
    the bounded retention window (``max_retired_generations``).  Distinct
    from a plain ``KeyError`` (unknown dataset name) so callers that pin
    generations — the planner — can retry on exactly this condition."""


# one vectorized counting-sort placement shared by all columns
_counting_sort_dest = host_counting_sort_dest


def _presorted_dest(counts: np.ndarray, cap: int,
                    dest_offsets: Optional[np.ndarray] = None) -> np.ndarray:
    """Same placement for rows already segmented per worker (write_layout):
    no sort needed, the worker id is implied by the segmentation.  A
    bucketed layout passes its per-partition ``dest_offsets``."""
    m = counts.shape[0]
    pids = np.repeat(np.arange(m, dtype=np.int64), counts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(pids.shape[0], dtype=np.int64) - offsets[pids]
    if dest_offsets is None:
        return pids * cap + rank
    return np.asarray(dest_offsets, dtype=np.int64)[pids] + rank


@dataclass
class StoredDataset:
    """One immutable generation of a named dataset.

    Column arrays are never mutated in place after construction; a layout
    change installs a NEW StoredDataset and atomically flips the store's
    name → generation pointer (DESIGN §8).  A reader holding this object
    therefore always sees one consistent generation.

    Layouts: with ``capacity_map=None`` (the default), columns are the
    uniform padded ``(m, capacity, ...)`` grid.  With a
    :class:`~repro_torch.data.capacity.CapacityMap`, columns are *flat*
    ``(total_slots, ...)`` and partition ``i`` occupies the slot range
    ``[offsets[i], offsets[i] + capacities[i])`` — the skew-adaptive
    layout (DESIGN §12).  ``gather()`` produces the identical row order
    for both.  Columns are numpy arrays (host backend) or torch tensors
    (device backend)."""
    name: str
    columns: Columns                   # (m, capacity, ...) or (slots, ...)
    counts: np.ndarray                 # (m,) valid rows per worker
    partitioner: Optional[PartitionerCandidate]
    num_rows: int
    nbytes: int
    created_at: float = field(default_factory=time.time)
    generation: int = 0
    capacity_map: Optional[CapacityMap] = None

    @property
    def num_workers(self) -> int:
        return int(self.counts.shape[0])

    @property
    def capacity(self) -> int:
        if self.capacity_map is not None:
            caps = self.capacity_map.capacities
            return int(caps.max()) if caps.size else 0
        return int(next(iter(self.columns.values())).shape[1])

    def slot_offsets(self) -> np.ndarray:
        """(m,) flat-slot base offset of each partition."""
        if self.capacity_map is not None:
            return self.capacity_map.offsets
        return np.arange(self.num_workers, dtype=np.int64) * self.capacity

    @property
    def total_slots(self) -> int:
        if self.capacity_map is not None:
            return self.capacity_map.total_slots
        return self.num_workers * self.capacity

    @property
    def padded_bytes(self) -> int:
        """Bytes actually occupied by the padded layout (incl. padding)."""
        return int(sum(int(v.nbytes) for v in self.columns.values()))

    @property
    def valid_bytes(self) -> int:
        """Bytes of real rows inside the padded layout."""
        slots = self.total_slots
        if slots <= 0:
            return 0
        return int(self.padded_bytes * (self.num_rows / slots))

    def skew(self) -> float:
        """max/mean partition fill — load-balance diagnostic."""
        mean = max(self.counts.mean(), 1e-9)
        return float(self.counts.max() / mean)

    @property
    def backend(self) -> str:
        """"device" when any column is a torch tensor."""
        return "device" if any(isinstance(v, torch.Tensor)
                               for v in self.columns.values()) else "host"

    def gather(self) -> Columns:
        """Materialize back to flat numpy rows, worker-major in rank order
        (:func:`~repro_torch.data.capacity.valid_slot_index`) — the same
        order for uniform and bucketed layouts.  Tensor columns are indexed
        on their device and copied to the host once."""
        idx = valid_slot_index(np.asarray(self.counts), self.slot_offsets())
        idx_dev: Dict[torch.device, torch.Tensor] = {}
        out: Columns = {}
        for k, v in self.columns.items():
            flat = v if self.capacity_map is not None else v.reshape(
                (self.total_slots,) + tuple(v.shape[2:]))
            if isinstance(v, torch.Tensor):
                if v.device not in idx_dev:
                    idx_dev[v.device] = torch.from_numpy(idx).to(v.device)
                out[k] = flat.index_select(0, idx_dev[v.device]).cpu().numpy()
            else:
                out[k] = np.asarray(flat)[idx]
        return out

    def to_host(self) -> "StoredDataset":
        """Copy with every column materialized as numpy (layout unchanged)."""
        cols = {k: to_numpy(v) for k, v in self.columns.items()}
        return StoredDataset(name=self.name, columns=cols,
                             counts=self.counts, partitioner=self.partitioner,
                             num_rows=self.num_rows, nbytes=self.nbytes,
                             created_at=self.created_at,
                             generation=self.generation,
                             capacity_map=self.capacity_map)


def _row_nbytes(v: torch.Tensor, slot_dims: int) -> int:
    """Bytes of one row of a padded column whose first ``slot_dims`` dims
    index slots."""
    return int(np.prod(tuple(v.shape[slot_dims:]))) * v.element_size()


def import_layout(columns: Dict[str, np.ndarray], counts, partitioner, *,
                  capacity_map: Optional[CapacityMap] = None,
                  device="cuda", name: str = "") -> StoredDataset:
    """A StoredDataset from an existing padded layout given as numpy arrays
    — e.g. the columns of a dataset written by the JAX package — with its
    columns moved to ``device`` bit for bit.

    Uniform layouts pass ``(m, capacity, ...)`` columns; bucketed ones pass
    ``(total_slots, ...)`` columns and their ``capacity_map``."""
    dev = resolve_device(device)
    counts = np.asarray(counts, np.int64)
    m = int(counts.shape[0])
    cols: Columns = {}
    for k, v in columns.items():
        v = np.asarray(v)
        if capacity_map is not None:
            if v.shape[0] != capacity_map.total_slots:
                raise ValueError(f"column {k!r} has {v.shape[0]} slots, the "
                                 f"capacity map {capacity_map.total_slots}")
        elif v.ndim < 2 or v.shape[0] != m:
            raise ValueError(f"column {k!r} has shape {v.shape}; a uniform "
                             f"layout needs ({m}, capacity, ...)")
        cols[k] = torch.from_numpy(np.array(v)).to(dev)      # owned copy
    num_rows = int(counts.sum())
    slot_dims = 1 if capacity_map is not None else 2
    nbytes = int(sum(_row_nbytes(v, slot_dims) for v in cols.values())
                 * num_rows)
    ds = StoredDataset(name=name, columns=cols, counts=counts,
                       partitioner=partitioner, num_rows=num_rows,
                       nbytes=nbytes, capacity_map=capacity_map)
    if capacity_map is None and cols and num_rows \
            and int(counts.max()) > ds.capacity:
        raise ValueError("counts exceed the layout's capacity")
    return ds


def export_layout(ds: StoredDataset) -> Dict[str, Any]:
    """The inverse of :func:`import_layout`: the padded columns, counts and
    capacity-map arrays of ``ds`` as numpy (``capacities``/``offsets`` are
    None for a uniform layout)."""
    cm = ds.capacity_map
    return {"columns": {k: to_numpy(v) for k, v in ds.columns.items()},
            "counts": np.asarray(ds.counts, np.int64).copy(),
            "capacities": None if cm is None else cm.capacities.copy(),
            "offsets": None if cm is None else cm.offsets.copy()}


class PartitionStore:
    def __init__(self, num_workers: int = 8, backend: str = "device",
                 device="cuda",
                 max_retired_generations: int = 2,
                 registry=None,
                 root: Optional[str] = None,
                 memory_budget_bytes: Optional[int] = None,
                 write_log_cap: int = DEFAULT_WRITE_LOG_CAP,
                 adaptive_capacity: bool = False,
                 capacity_threshold: float = 0.75,
                 cluster=None):
        if root is not None or memory_budget_bytes is not None:
            raise NotImplementedError(
                f"root=/memory_budget_bytes=: {_DURABLE_ITEM}")
        if cluster is not None:
            raise NotImplementedError(f"cluster=: {_CLUSTER_ITEM}")
        # UnknownBackendError on typos; `registry` (default: the global
        # one) lets a Session thread its own registry through, so custom
        # backends registered there resolve here too
        b = resolve_backend(backend, registry)
        self.backend = b.name
        # capability, not name: a registered custom backend with
        # device_resident=True gets device-resident columns too
        self._device_resident = b.device_resident
        # a host store never touches a device; a device store raises here
        # when its device is CUDA and no card is present
        self.device = resolve_device(device) if b.device_resident \
            else torch.device("cpu")
        # skew-adaptive layout (DESIGN §12): opt-in — when on, writes whose
        # histogram is skewed enough get a bucketed CapacityMap layout
        # instead of the uniform worst-case capacity
        self.adaptive_capacity = bool(adaptive_capacity)
        self.capacity_threshold = float(capacity_threshold)
        self.datasets: Dict[str, StoredDataset] = {}
        self.write_log: List[Dict[str, Any]] = []
        self.write_log_cap = int(write_log_cap)
        #: monotone aggregates over ALL writes (including entries evicted
        #: from the bounded write_log) — benchmarks read these
        self.write_totals: Dict[str, float] = {
            "entries": 0, "rows": 0, "bytes": 0, "latency_s": 0.0,
            "evicted": 0, "padded_bytes": 0, "valid_bytes": 0,
            "max_skew": 0.0}
        # generation machinery (DESIGN §8): `datasets` maps each name to its
        # CURRENT generation; superseded generations are retained (bounded)
        # so in-flight readers can still resolve them by number.
        self.max_retired_generations = max_retired_generations
        self._retired: Dict[str, List[StoredDataset]] = {}
        # Concurrency contract (DESIGN §11): the name→StoredDataset pointer
        # flip is one dict assignment, so READS ARE LOCK-FREE.
        # ``_swap_lock`` is the writer side: it serializes pointer flips and
        # retired-list maintenance, while readers never wait.
        self._swap_lock = threading.Lock()
        self._install_locks: Dict[str, threading.Lock] = {}
        self._log_lock = threading.Lock()
        self.m = num_workers

    def _log_write(self, entry: Dict[str, Any]) -> None:
        """Append a write_log row, folding overflow into the monotone
        aggregates so the log stays bounded under sustained traffic.
        Serialized: concurrent writers must not lose counter increments to
        read-modify-write races."""
        with self._log_lock:
            self.write_log.append(entry)
            t = self.write_totals
            t["entries"] += 1
            t["rows"] += int(entry.get("rows", 0))
            t["bytes"] += int(entry.get("bytes", 0))
            t["latency_s"] += float(entry.get("latency", 0.0))
            t["padded_bytes"] += int(entry.get("padded_bytes", 0))
            t["valid_bytes"] += int(entry.get("valid_bytes", 0))
            t["max_skew"] = max(t["max_skew"],
                                float(entry.get("skew", 0.0)))
            while len(self.write_log) > self.write_log_cap:
                self.write_log.pop(0)
                t["evicted"] += 1

    def write_stats(self) -> Dict[str, float]:
        """Cumulative write counters (monotone across write_log eviction)."""
        with self._log_lock:
            return dict(self.write_totals)

    def register_metrics(self, registry) -> None:
        """Expose this store's cumulative stats through a
        :class:`~repro_torch.obs.metrics.MetricsRegistry` (idempotent per
        registry), as snapshot-time callbacks."""
        marker = id(registry)
        regs = getattr(self, "_metric_registries", None)
        if regs is None:
            regs = self._metric_registries = set()
        if marker in regs:
            return
        regs.add(marker)
        registry.register_callback(self, PartitionStore._metric_samples)

    def _metric_samples(self):
        for k, v in self.write_stats().items():
            yield f"store_write_{k}", {}, float(v)
        yield "store_datasets", {}, float(len(self.datasets))
        yield "store_resident_bytes", {}, float(self.resident_bytes())

    def _name_lock(self, name: str) -> threading.Lock:
        with self._swap_lock:
            return self._install_locks.setdefault(name, threading.Lock())

    def _install(self, name: str, ds: StoredDataset) -> StoredDataset:
        """Atomically make ``ds`` the current generation of ``name``.

        The flip is a single dict assignment under the (global) swap lock;
        readers that already hold the previous StoredDataset keep reading
        it unchanged (generations are immutable)."""
        with _span("store.install", "store", dataset=name) as sp:
            with self._name_lock(name):
                prev = self.datasets.get(name)
                if prev is not None:
                    ds.generation = prev.generation + 1
                with self._swap_lock:
                    if prev is not None:
                        retired = self._retired.setdefault(name, [])
                        retired.append(prev)
                        if len(retired) > self.max_retired_generations:
                            del retired[:len(retired)
                                        - self.max_retired_generations]
                    self.datasets[name] = ds
            sp.set(generation=ds.generation)
        return ds

    def resident_bytes(self) -> int:
        """Bytes of column data held in host or device memory, retired-but-
        retained generations included."""
        with self._swap_lock:
            live = list(self.datasets.values())
            retired = [d for lst in self._retired.values() for d in lst]
        return int(sum(int(v.nbytes) for ds in live + retired
                       for v in list(ds.columns.values())))

    # -- write path (storage-time partitioning) ------------------------------
    def write(self, name: str, data: Columns,
              partitioner: Optional[PartitionerCandidate] = None,
              seed: int = 0) -> StoredDataset:
        """Dispatch each row to a worker via ``g(d_i)`` and store it."""
        t0 = time.perf_counter()
        n = len(next(iter(data.values())))
        if partitioner is None:
            partitioner = PartitionerCandidate(graph=None, strategy=ROUND_ROBIN)

        with _span("store.write", "store", dataset=name, rows=n,
                   strategy=partitioner.strategy):
            if self._device_resident:
                columns, counts, cmap = self._dispatch_device(
                    data, partitioner, n, seed)
            else:
                columns, counts, cmap = self._dispatch_host(
                    data, partitioner, n, seed)

        nbytes = int(sum(np.asarray(v).nbytes for v in data.values()))
        ds = StoredDataset(name=name, columns=columns,
                           counts=counts.astype(np.int64),
                           partitioner=partitioner, num_rows=n, nbytes=nbytes,
                           capacity_map=cmap)
        self._install(name, ds)
        self._log_write({
            "name": name, "rows": n, "bytes": nbytes,
            "strategy": partitioner.strategy,
            "latency": time.perf_counter() - t0,
            "skew": ds.skew(),
            "padded_bytes": ds.padded_bytes,
            "valid_bytes": ds.valid_bytes,
            "bucketed": cmap is not None,
            "generation": ds.generation,
        })
        return ds

    def import_layout(self, name: str, columns: Dict[str, np.ndarray],
                      counts, partitioner, *,
                      capacity_map: Optional[CapacityMap] = None
                      ) -> StoredDataset:
        """Install an existing padded layout (numpy arrays, see
        :func:`import_layout`) as the current generation of ``name``."""
        if not self._device_resident:
            raise ValueError("import_layout needs a device-resident store")
        ds = import_layout(columns, counts, partitioner,
                           capacity_map=capacity_map, device=self.device,
                           name=name)
        return self._install(name, ds)

    def _plan_cmap(self, counts) -> Optional[CapacityMap]:
        """Counts → bucketed CapacityMap when adaptive capacity is on and
        the re-layout saves enough padding; None ⇒ stay uniform."""
        if not self.adaptive_capacity:
            return None
        return plan_capacity_map(counts, threshold=self.capacity_threshold)

    # -- dispatch backends ---------------------------------------------------
    def _host_pids(self, data: Columns, partitioner: PartitionerCandidate,
                   n: int, seed: int) -> np.ndarray:
        pids = to_numpy(partitioner.partition_ids(data, self.m)) \
            if partitioner.strategy != RANDOM else \
            np.random.default_rng(seed).integers(0, self.m, size=n)
        return np.asarray(pids, np.int64)

    def _dispatch_host(self, data, partitioner, n, seed):
        """Host-side numpy dispatch: one counting-sort placement, then a
        single vectorized scatter per column (no per-worker Python loop)."""
        pids = self._host_pids(data, partitioner, n, seed)
        counts = np.bincount(pids, minlength=self.m)
        cmap = self._plan_cmap(counts)
        if cmap is not None:
            dest = _counting_sort_dest(pids, counts, 0,
                                       dest_offsets=cmap.offsets)
            total = cmap.total_slots
            columns: Columns = {}
            for k, v in data.items():
                v = np.asarray(v)
                buf = np.zeros((total,) + v.shape[1:], v.dtype)
                buf[dest] = v
                columns[k] = buf
            return columns, counts, cmap
        cap = int(counts.max()) if n else 1
        dest = _counting_sort_dest(pids, counts, cap)
        columns = {}
        for k, v in data.items():
            v = np.asarray(v)
            buf = np.zeros((self.m * cap,) + v.shape[1:], v.dtype)
            buf[dest] = v
            columns[k] = buf.reshape((self.m, cap) + v.shape[1:])
        return columns, counts, None

    def _dispatch_device(self, data, partitioner, n, seed):
        """Device dispatch (DESIGN §5): hash keys through the hash kernel,
        re-bucket with the scatter plan consuming its (pids, histogram)
        output.  Keyless/range strategies — and partitioners that opt out
        of kernel dispatch (SaltedPartitioner's pid math is not the plain
        key hash) — keep their host pid computation but still scatter on
        the device, so the stored columns are device-resident."""
        if (partitioner.strategy == HASH and partitioner.graph is not None
                and getattr(partitioner, "kernel_dispatchable", True)):
            keys = partitioner.key_fn()(data)
            pids, counts = shuffle_pids(keys, self.m, device=self.device)
        else:
            pids = self._host_pids(data, partitioner, n, seed)
            counts = np.bincount(pids, minlength=self.m).astype(np.int64)
        cmap = self._plan_cmap(counts)
        columns = device_scatter_padded(data, pids, counts,
                                        capacity_map=cmap, device=self.device)
        return columns, counts, cmap

    def write_layout(self, name: str, flat_columns: Columns,
                     counts: np.ndarray,
                     partitioner: Optional[PartitionerCandidate],
                     device_columns: Optional[Columns] = None
                     ) -> StoredDataset:
        """Store an ALREADY-partitioned table (flat columns segmented per
        worker by ``counts``) without re-dispatching — used when a workload
        materializes an output whose layout was produced by its own
        partition nodes (e.g. iterative PageRank writing updated ranks).

        ``device_columns`` — device-resident flats from an upstream device
        shuffle (d2d chain); the device scatter consumes them in place of
        re-uploading the matching host columns."""
        counts = np.asarray(counts, np.int64)
        n = int(counts.sum())
        cmap = self._plan_cmap(counts)
        columns = self._materialize_layout(flat_columns, counts, cmap,
                                           device_columns=device_columns)
        nbytes = int(sum(np.asarray(v).nbytes for v in flat_columns.values()))
        ds = StoredDataset(name=name, columns=columns, counts=counts,
                           partitioner=partitioner, num_rows=n, nbytes=nbytes,
                           capacity_map=cmap)
        return self._install(name, ds)

    def _materialize_layout(self, flat_columns: Columns, counts: np.ndarray,
                            cmap: Optional[CapacityMap],
                            device_columns: Optional[Columns] = None
                            ) -> Columns:
        """Rows already segmented per worker (pids implied by ``counts``) →
        padded columns: uniform ``(m, cap, ...)`` when ``cmap`` is None,
        flat bucketed ``(total_slots, ...)`` otherwise."""
        n = int(counts.sum())
        cap = int(counts.max()) if n else 1
        if self._device_resident:
            pids = np.repeat(np.arange(self.m, dtype=np.int32), counts)
            return device_scatter_padded(
                flat_columns, pids, counts,
                capacity=None if cmap is not None else cap,
                capacity_map=cmap, device=self.device,
                device_columns=device_columns)
        if cmap is not None:
            dest = _presorted_dest(counts, 0, dest_offsets=cmap.offsets)
            total = cmap.total_slots
            columns: Columns = {}
            for k, v in flat_columns.items():
                v = np.asarray(v)
                buf = np.zeros((total,) + v.shape[1:], v.dtype)
                buf[dest] = v
                columns[k] = buf
            return columns
        dest = _presorted_dest(counts, cap)
        columns = {}
        for k, v in flat_columns.items():
            v = np.asarray(v)
            buf = np.zeros((self.m * cap,) + v.shape[1:], v.dtype)
            buf[dest] = v
            columns[k] = buf.reshape((self.m, cap) + v.shape[1:])
        return columns

    # -- read path -------------------------------------------------------------
    def read(self, name: str,
             generation: Optional[int] = None) -> StoredDataset:
        """Current generation of ``name``; pass ``generation`` to resolve a
        specific (possibly superseded, still-retained) one.

        Thread-safety (DESIGN §11): the current-generation hot path is
        LOCK-FREE — one dict lookup resolves an immutable StoredDataset.
        Only the retired-generation fallback briefly takes the writer lock
        to snapshot the retention list."""
        ds = self.datasets[name]
        if generation is None or ds.generation == generation:
            return ds
        with self._swap_lock:
            retained = list(self._retired.get(name, ()))
        for old in reversed(retained):
            if old.generation == generation:
                return old
        raise RetiredGenerationError(
            f"{name}@gen{generation} not found "
            f"(current gen {ds.generation}, retains last "
            f"{self.max_retired_generations})")

    # -- shuffle (the operation Lachesis exists to avoid) ------------------------
    def repartition(self, ds: StoredDataset,
                    partitioner: PartitionerCandidate,
                    name: Optional[str] = None,
                    swap: bool = False) -> Tuple[StoredDataset, int]:
        """Full shuffle.  Returns (new ds, bytes moved).

        Bytes moved = (m-1)/m of the dataset on average (every row whose new
        worker differs from its current one crosses the network).

        Device-to-device fast path (DESIGN §5): when both the store and the
        dataset are device-backed and the target is a keyed hash
        partitioner, the shuffle runs entirely on the device — flatten by a
        device gather, hash with the compiled key projection, counting-sort
        scatter into the new layout — with no host ``gather()``.

        ``swap=True`` (DESIGN §8) rewrites the dataset *in place* as a new
        generation under its own name: the whole shuffle materializes off
        to the side, then one atomic pointer flip publishes it."""
        t0 = time.perf_counter()
        moved = int(ds.nbytes * (self.m - 1) / self.m)
        name = name or (ds.name if swap else ds.name + "@reparted")
        with _span("store.repartition", "store", dataset=name,
                   bytes_moved=moved, swap=swap) as rsp:
            if (self._device_resident and ds.backend == "device"
                    and partitioner.strategy == HASH
                    and partitioner.graph is not None
                    and getattr(partitioner, "kernel_dispatchable", True)):
                rsp.set(path="d2d")
                columns, counts, cmap = device_repartition_dataset(
                    ds, partitioner, self.m, plan_capacity=self._plan_cmap)
                new = StoredDataset(name=name, columns=columns, counts=counts,
                                    partitioner=partitioner,
                                    num_rows=int(counts.sum()),
                                    nbytes=ds.nbytes, capacity_map=cmap)
                self._install(name, new)
                self._log_write({
                    "name": name, "rows": new.num_rows, "bytes": new.nbytes,
                    "strategy": partitioner.strategy,
                    "latency": time.perf_counter() - t0,
                    "skew": new.skew(), "path": "d2d",
                    "padded_bytes": new.padded_bytes,
                    "valid_bytes": new.valid_bytes,
                    "bucketed": cmap is not None,
                    "generation": new.generation,
                })
            else:
                rsp.set(path="host")
                new = self.write(name, ds.gather(), partitioner)
        return new, moved
