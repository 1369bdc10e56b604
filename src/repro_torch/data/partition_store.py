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

Durability (DESIGN §10): pass ``root=`` to back the store with the
:mod:`~repro_torch.data.storage` tier — every published generation is
written as per-column segment files (already in the padded layout, so
reopening is a zero-copy ``np.memmap``) under a crash-safe manifest, in the
JAX package's on-disk format; a fresh process reattaches with
:meth:`PartitionStore.open` (or ``lachesis_torch.Session(store_path=...)``)
and consumers elide their shuffles against layouts a previous application
paid for.  ``memory_budget_bytes`` turns on the eviction loop: cold
datasets spill to their segments (a device column's memory is freed), reads
lazily rehydrate, and a device-resident store prefetches host→device on
read.  The cluster tier (DESIGN §14: ``cluster=``, or a root holding
``cluster.json``) shards the durable tier across directories-as-nodes; its
columns are reassembled from per-node parts in RAM and, on a device store,
moved to the store's device as they attach.

:func:`import_layout` and :func:`export_layout` carry a stored layout across
as numpy arrays (the port's counterpart of carried weights: this system's
state is its stored layout).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.backends import resolve_backend, resolve_device
from ..core.ir import to_numpy
from ..core.partitioner import (HASH, PartitionerCandidate, RANDOM,
                                ROUND_ROBIN)
from ..core.sharding_bridge import ShardedColumn, count_whole_read
from ..obs.tracer import recording as _recording
from ..obs.tracer import span as _span
from .capacity import CapacityMap, plan_capacity_map, valid_slot_index
from .device_repartition import (device_repartition_dataset,
                                 device_scatter_padded, flatten_blocks,
                                 flatten_dataset, host_counting_sort_dest,
                                 sharded_repartition_dataset, shuffle_pids)


Columns = Dict[str, Any]

#: write_log entries retained verbatim; older entries fold into the
#: monotone ``write_totals`` aggregates
DEFAULT_WRITE_LOG_CAP = 256


def _numel(v) -> int:
    return v.numel() if isinstance(v, (torch.Tensor, ShardedColumn)) \
        else int(v.size)


def _placed(ds) -> bool:
    """Every column placed on a mesh (``sharding_bridge.device_put_dataset``
    or a repartition onto one)."""
    return bool(ds.columns) and all(isinstance(v, ShardedColumn)
                                    for v in ds.columns.values())


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
    for both.  Columns are numpy arrays (host backend), torch tensors
    (device backend) or, placed on a mesh, ``ShardedColumn``\\ s (device
    backend; each column carries its sharding)."""
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

    def slot_capacities(self) -> np.ndarray:
        """(m,) per-partition slot capacities (uniform ⇒ all equal)."""
        if self.capacity_map is not None:
            return self.capacity_map.capacities
        return np.full(self.num_workers, self.capacity, dtype=np.int64)

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

    def padding_waste(self) -> int:
        """Bytes spent on padding alone — what skew costs this layout."""
        return max(self.padded_bytes - self.valid_bytes, 0)

    def skew(self) -> float:
        """max/mean partition fill — load-balance diagnostic."""
        mean = max(self.counts.mean(), 1e-9)
        return float(self.counts.max() / mean)

    @property
    def backend(self) -> str:
        """"device" when any column is a torch tensor or placed on a mesh
        (a spilled device dataset reads "host" until a read prefetches
        it)."""
        return "device" if any(isinstance(v, (torch.Tensor, ShardedColumn))
                               for v in self.columns.values()) else "host"

    @property
    def spilled(self) -> bool:
        """True when every column is a disk-backed memmap view (the
        eviction loop's cold state — reads page in lazily).  Zero-size
        columns hold no memory and cannot be memmapped, so they don't
        count against the cold state."""
        cols = [v for v in self.columns.values() if _numel(v)]
        return bool(self.columns) and all(isinstance(v, np.memmap)
                                          for v in cols)

    def gather(self) -> Columns:
        """Materialize back to flat numpy rows, worker-major in rank order
        (:func:`~repro_torch.data.capacity.valid_slot_index`) — the same
        order for uniform and bucketed layouts.  Tensor columns are indexed
        on their device and copied to the host once; a column placed on a
        mesh is indexed shard by shard, each block on its own device, and
        counted as a whole-column read; memmap columns (a spilled, or
        half-spilled, dataset) are read through their pages."""
        idx = valid_slot_index(np.asarray(self.counts), self.slot_offsets())
        idx_dev: Dict[torch.device, torch.Tensor] = {}
        out: Columns = {}
        sharded = flatten_blocks(self, {k: v for k, v in self.columns.items()
                                        if isinstance(v, ShardedColumn)})
        for k, v in self.columns.items():
            if k in sharded:
                count_whole_read()
                out[k] = np.concatenate([t.cpu().numpy()
                                         for t in sharded[k]])
                continue
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
                 autoflush: bool = True,
                 write_log_cap: int = DEFAULT_WRITE_LOG_CAP,
                 adaptive_capacity: bool = False,
                 capacity_threshold: float = 0.75,
                 cluster=None):
        # UnknownBackendError on typos; `registry` (default: the global
        # one) lets a Session thread its own registry through, so custom
        # backends registered there resolve here too
        b = resolve_backend(backend, registry)
        self.backend = b.name
        # capability, not name: a registered custom backend with
        # device_resident=True gets device-resident columns too
        self._device_resident = b.device_resident
        self._storage_prefetch = b.storage_prefetch
        # a host store never touches a device; a device store raises here
        # when its device is CUDA and no card is present
        self.device = resolve_device(device) if b.device_resident \
            else torch.device("cpu")
        # every card synchronize() waits on: the store's, and those of the
        # meshes it repartitions from and onto
        self._cards = {self.device} if self.device.type == "cuda" else set()
        self._cards_lock = threading.Lock()
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
        # ``_swap_lock`` is the writer side: it serializes pointer flips,
        # retired-list maintenance and container swaps (spill/prefetch), while
        # readers never wait.
        self._swap_lock = threading.Lock()
        self._install_locks: Dict[str, threading.Lock] = {}
        self._log_lock = threading.Lock()
        self._evict_lock = threading.Lock()
        # injectable sync points (set_sync_point): named callables invoked
        # at the store's sharp edges.  Empty unless a test or a measurement
        # sets one.
        self._sync_points: Dict[str, Callable[[], None]] = {}
        # durable tier (DESIGN §10)
        self.autoflush = autoflush
        self.memory_budget_bytes = memory_budget_bytes
        self._dirty: set = set()
        self._last_access: Dict[str, int] = {}
        self._access_clock = itertools.count(1)
        self.durable = None
        # cluster tier (DESIGN §14): health tracking + the rebalance path
        # exist only when the durable tier is a ClusterDurableStore
        self.health = None
        # durable-only observability (DESIGN §15): per-run telemetry
        # history and the regression watchdog reading it
        self.telemetry = None
        self.watchdog = None
        if cluster is not None and root is None:
            raise ValueError("cluster=ClusterConfig(...) needs root= "
                             "(nodes are directories under the store root)")
        if root is not None:
            from ..obs.telemetry import TelemetryStore
            from ..obs.watchdog import RegressionDetector
            from .storage.durable import DurableStore
            if cluster is not None or os.path.exists(
                    os.path.join(root, "cluster.json")):
                if memory_budget_bytes is not None:
                    raise ValueError(
                        "a cluster store does not support "
                        "memory_budget_bytes: columns are reassembled "
                        "in RAM from per-node parts and cannot be "
                        "memmap-swapped to a single local segment")
                from ..cluster.control import ClusterHealth
                from ..cluster.node import ClusterDurableStore
                self.durable = ClusterDurableStore(
                    root, num_workers=num_workers,
                    max_retired_generations=max_retired_generations,
                    cluster=cluster)
                # health watches the LIVE membership (directory epoch),
                # not the bootstrap config; wired before _attach so the
                # very first reads feed the straggler detector
                self.health = ClusterHealth(self.durable.directory.nodes)
                self.durable.health = self.health
            else:
                self.durable = DurableStore(
                    root, num_workers=num_workers,
                    max_retired_generations=max_retired_generations)
            # an existing catalog is authoritative for the worker count —
            # segment layouts are (m, capacity) and cannot be re-bucketed
            # on open without a shuffle
            if self.durable.num_workers is not None:
                num_workers = self.durable.num_workers
            # telemetry and baselines live under the same root, so they
            # survive restarts with the data they describe
            self.telemetry = TelemetryStore(root)
            self.watchdog = RegressionDetector(self.telemetry)
            self._attach()
        self.m = num_workers

    @classmethod
    def open(cls, root: str, **kwargs) -> "PartitionStore":
        """Reattach to a durable store directory written by a previous
        process (either package's).  Worker count and dataset layouts come
        from the on-disk catalog; ``backend=``, ``device=`` etc. are this
        process's choices."""
        return cls(root=root, **kwargs)

    @property
    def is_durable(self) -> bool:
        return self.durable is not None

    @property
    def root(self) -> Optional[str]:
        return self.durable.root if self.durable is not None else None

    # -- cluster tier (DESIGN §14) -------------------------------------------
    @property
    def is_cluster(self) -> bool:
        return getattr(self.durable, "is_cluster", False)

    @property
    def directory(self):
        """Current :class:`~repro_torch.cluster.directory.PartitionDirectory`
        epoch (None on a non-cluster store)."""
        return self.durable.directory if self.is_cluster else None

    @property
    def cluster_config(self):
        return self.durable.cluster if self.is_cluster else None

    @property
    def placement_epoch(self) -> int:
        """Placement generation the planner pins into PlanKeys: a
        rebalance bumps it, invalidating exactly the plans compiled
        against the old placement.  -1 on non-cluster stores (one value
        for every single-host store, so their keys are unaffected)."""
        return self.durable.directory.epoch if self.is_cluster else -1

    def plan_rebalance(self, **kwargs):
        """Plan (without applying) an incremental placement change —
        see :meth:`repro_torch.cluster.rebalancer.Rebalancer.plan`."""
        from ..cluster.rebalancer import Rebalancer
        return Rebalancer(self).plan(**kwargs)

    def rebalance(self, plan=None, *, abort_after: Optional[int] = None,
                  on_abort=None, **kwargs):
        """Apply a placement change: ``plan`` from :meth:`plan_rebalance`,
        or plan-and-apply in one step (kwargs as for plan_rebalance).
        Returns a :class:`~repro_torch.cluster.rebalancer.RebalanceResult`."""
        from ..cluster.rebalancer import Rebalancer
        r = Rebalancer(self)
        if plan is None:
            plan = r.plan(**kwargs)
        return r.apply(plan, abort_after=abort_after, on_abort=on_abort)

    def synchronize(self) -> None:
        """Wait for the device work queued on the store's device and on
        every card of the meshes it has repartitioned from or onto (no-op
        on the CPU).  Kernel launches are asynchronous: a host clock read
        right after a device repartition would stop before its scatter and
        gathers end, so every wall that prices device work reads the clock
        after this."""
        with self._cards_lock:
            cards = sorted(self._cards, key=str)
        for card in cards:
            torch.cuda.synchronize(card)

    def _note_cards(self, mesh, ds: StoredDataset) -> None:
        """Add the cards ``ds`` is placed on and ``mesh``'s to those
        :meth:`synchronize` waits on."""
        devs = [d for v in ds.columns.values()
                if isinstance(v, ShardedColumn) for d in v.devices]
        if mesh is not None:
            devs += list(mesh.devices.flat)
        with self._cards_lock:
            self._cards.update(d for d in devs if d.type == "cuda")

    def _attach(self) -> None:
        """Load every dataset's newest consistent generation as memmap
        views (zero-copy; nothing is paged in until first touch).  A
        cluster store's columns are reassembled from node parts instead,
        and a device store moves them to its device."""
        for name, ds in self.durable.load_all().items():
            self.datasets[name] = self._cluster_resident(ds)

    def _cluster_resident(self, ds: StoredDataset) -> StoredDataset:
        """A cluster-loaded generation with its reassembled numpy columns
        moved to the store's device when the store is device-resident (one
        H2D copy per column, synchronized); unchanged otherwise."""
        if not (self.is_cluster and self._storage_prefetch):
            return ds
        with _span("cluster.attach", "cluster", dataset=ds.name,
                   generation=ds.generation) as sp:
            ds.columns = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                          for k, v in ds.columns.items()}
            self.synchronize()
            sp.set(bytes=ds.padded_bytes)
        return ds

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
        # the watchdog's coalesce-rate series reads serving counters out
        # of whichever registry the session exports through
        if self.watchdog is not None and self.watchdog.registry is None:
            self.watchdog.registry = registry

    def _metric_samples(self):
        for k, v in self.write_stats().items():
            yield f"store_write_{k}", {}, float(v)
        for k, v in self.io_snapshot().items():
            yield f"store_io_{k}", {}, float(v)
        yield "store_datasets", {}, float(len(self.datasets))
        yield "store_resident_bytes", {}, float(self.resident_bytes())
        if self.telemetry is not None:
            st = self.telemetry.stats()
            yield "telemetry_records", {}, float(st["records"])
            yield "telemetry_appends_total", {}, float(st["appends"])
            yield "telemetry_compactions_total", {}, float(st["compactions"])
        if self.watchdog is not None:
            yield ("watchdog_perf_regressions_total", {},
                   float(self.watchdog.raised_total))
            yield "watchdog_checks_total", {}, float(self.watchdog.checks)
        if self.is_cluster:
            for k, v in self.durable.cluster_snapshot().items():
                yield f"cluster_{k}", {}, float(v)
            d = self.durable.directory
            yield "cluster_epoch", {}, float(d.epoch)
            yield "cluster_directory_lookups_total", {}, float(d.lookups)
            yield "cluster_nodes", {}, float(len(d.nodes))
            if self.health is not None:
                yield ("cluster_heartbeat_misses_total", {},
                       float(self.health.heartbeat_misses))
                yield ("cluster_straggler_reissues_total", {},
                       float(self.health.straggler_reissues))
                yield ("cluster_nodes_alive", {},
                       float(len(self.health.alive_nodes())))

    # -- sync points: race tests and measurement (DESIGN §11) ---------------
    def set_sync_point(self, point: str,
                       fn: Optional[Callable[[], None]]) -> None:
        """Install (or with ``None`` remove) a callable invoked when store
        internals cross ``point`` — ``install:pre_flip``,
        ``install:post_flip``, ``spill:column``, ``spill:post_swap``,
        ``prefetch:pre_swap`` — so concurrency tests reproduce
        interleavings deterministically with :class:`threading.Event`
        barriers instead of sleeps, and a measurement can read the clock
        and device memory at the exact edges of a spill
        (``chip_smoke.py`` phase 9).  Serving stores never set these."""
        if fn is None:
            self._sync_points.pop(point, None)
        else:
            self._sync_points[point] = fn

    def _sync(self, point: str) -> None:
        fn = self._sync_points.get(point)
        if fn is not None:
            fn()

    def _name_lock(self, name: str) -> threading.Lock:
        with self._swap_lock:
            return self._install_locks.setdefault(name, threading.Lock())

    def _install(self, name: str, ds: StoredDataset,
                 persist: Optional[Callable[[StoredDataset], Any]] = None
                 ) -> StoredDataset:
        """Atomically make ``ds`` the current generation of ``name``.

        The flip is a single dict assignment under the (global) swap lock;
        readers that already hold the previous StoredDataset keep reading
        it unchanged (generations are immutable).  On a durable store with
        autoflush the generation is persisted (segments → manifest →
        CURRENT) *before* the in-memory flip, so the disk pointer never
        runs ahead of a generation that fully exists.  The fsync-bound
        persist runs under a per-NAME lock only, so a slow repartition of
        one dataset never blocks writers of another.

        ``persist`` overrides the default durable publication for this
        install (always invoked, regardless of autoflush) — the
        Rebalancer passes one that republishes under a NEW placement
        epoch, keeping the flip semantics identical for MVCC readers."""
        with _span("store.install", "store", dataset=name) as sp:
            with self._name_lock(name):
                prev = self.datasets.get(name)
                if prev is not None:
                    ds.generation = prev.generation + 1
                if self.durable is not None:
                    if persist is not None:
                        persist(ds)
                        self._dirty.discard(name)
                    elif self.autoflush:
                        self.durable.persist(ds)
                        self._dirty.discard(name)
                    else:
                        self._dirty.add(name)
                self._sync("install:pre_flip")
                with self._swap_lock:
                    if prev is not None:
                        retired = self._retired.setdefault(name, [])
                        retired.append(prev)
                        if len(retired) > self.max_retired_generations:
                            del retired[:len(retired)
                                        - self.max_retired_generations]
                    self.datasets[name] = ds
                self._sync("install:post_flip")
            sp.set(generation=ds.generation)
        self._touch(name)
        self._maybe_evict()
        return ds

    def generation_of(self, name: str) -> int:
        return self.datasets[name].generation

    # -- durability (DESIGN §10) ---------------------------------------------
    def flush(self, name: Optional[str] = None) -> int:
        """Persist pending generations to the durable tier (all datasets,
        or just ``name``).  Returns the number of generations published.
        No-op (0) on a memory-only store."""
        if self.durable is None:
            return 0
        names = [name] if name is not None else sorted(list(self.datasets))
        published = 0
        for n in names:
            ds = self.datasets.get(n)
            if ds is None:
                continue
            if n in self._dirty or not self.durable.has_generation(
                    n, ds.generation):
                self.durable.persist(ds)
                self._dirty.discard(n)
                published += 1
        return published

    def io_snapshot(self) -> Dict[str, float]:
        """Copy of the durable tier's I/O counters (empty when memory-only).
        The executor diffs this around a run to attribute storage I/O."""
        if self.durable is None:
            return {}
        return self.durable.io_snapshot()

    # -- eviction loop ---------------------------------------------------------
    def _touch(self, name: str) -> None:
        # itertools.count is a single C-level op — atomic under the GIL, so
        # concurrent readers never lose a tick (LRU stays consistent)
        self._last_access[name] = next(self._access_clock)

    def resident_bytes(self) -> int:
        """Bytes of column data held in host or device memory (spilled
        memmap views count as 0 — they are disk-backed).  Retired-but-
        retained generations count too: they hold real memory until their
        retention window closes."""
        with self._swap_lock:
            # snapshot under the writer lock: a concurrent install/retire
            # must not resize these containers mid-iteration
            live = list(self.datasets.values())
            retired = [d for lst in self._retired.values() for d in lst]
        return int(sum(int(v.nbytes) for ds in live + retired
                       for v in list(ds.columns.values())
                       if not isinstance(v, np.memmap)))

    def namespace_bytes(self, prefix: str = "") -> int:
        """Logical bytes of every current-generation dataset whose name
        starts with ``prefix`` — the serving tier's per-tenant accounting
        (tenants own disjoint name prefixes, DESIGN §11)."""
        with self._swap_lock:
            live = [d for n, d in self.datasets.items()
                    if n.startswith(prefix)]
        return int(sum(d.nbytes for d in live))

    def is_spilled(self, name: str) -> bool:
        return self.datasets[name].spilled

    def spill(self, name: str) -> bool:
        """Evict ``name``'s current generation to its segment files: columns
        become read-only memmap views (bit-identical by construction) and
        the store drops its references to the host arrays or device
        tensors, so their memory is freed once no reader holds them.
        Persists first if the generation isn't durable yet.  Returns False
        on a memory-only store, and on a cluster store (assembled columns
        span per-node parts — no single local segment to memmap)."""
        if self.durable is None or self.is_cluster:
            return False
        # the per-name lock serializes spill against a concurrent _install
        # of the same dataset (the generation sequence stays linear); other
        # datasets' writers are unaffected
        with _span("store.spill", "store", dataset=name) as sp:
            with self._name_lock(name):
                ds = self.datasets[name]
                if ds.spilled:
                    return True
                self.flush(name)
                man = self.durable.load_manifest(name, ds.generation)
                if man is None:          # validation failed — keep resident
                    sp.set(ok=False)
                    return False
                sp.set(generation=ds.generation)
                return self._swap_to_segments(ds, man)

    def _swap_to_segments(self, ds: StoredDataset, man) -> bool:
        """Replace ``ds``'s column containers with memmap views of their
        persisted segments (same bits, shared by every reader).

        Each column flips under the writer lock individually; a reader
        mid-``gather()`` may observe some columns resident and some as
        memmap views — bit-identical by construction (the ``spill:column``
        sync point lets the race tests freeze exactly that mixed state)."""
        freed = sum(int(v.nbytes) for v in list(ds.columns.values())
                    if not isinstance(v, np.memmap))
        cols = self.durable.open_columns(ds.name, man)
        for k in list(ds.columns):
            self._sync("spill:column")
            with self._swap_lock:
                ds.columns[k] = cols[k]
        self._sync("spill:post_swap")
        self.durable.io_add(spills=1, spilled_bytes=freed)
        return True

    def _spill_retired(self) -> int:
        """Evict retired-but-retained generations first: they hold real
        memory, are never read on the hot path, and the durable tier
        retains the same generation window on disk."""
        spilled = 0
        for name, lst in self._retired.items():
            for old in lst:
                if old.spilled:
                    continue
                if not self.durable.has_generation(name, old.generation):
                    # segments + manifest only: CURRENT must never move
                    # backwards to a superseded generation
                    self.durable.persist(old, publish_current=False)
                man = self.durable.load_manifest(name, old.generation)
                if man is not None and self._swap_to_segments(old, man):
                    spilled += 1
        return spilled

    def prefetch(self, name: str) -> bool:
        """Promote a spilled dataset back to residency: in-RAM copies on a
        host store, tensors on the store's device (host→device prefetch)
        on a device-resident one.  Every column goes to the device — torch
        holds int64 and float64 there, where the JAX package keeps them on
        the host.  Returns True when the dataset is resident; a failed
        read or copy raises."""
        with _span("store.prefetch", "store", dataset=name) as psp:
            with self._name_lock(name):
                ds = self.datasets[name]
                if not ds.spilled:
                    return True
                t0 = time.perf_counter()
                loaded = 0
                promoted: Columns = {}
                for k, v in list(ds.columns.items()):
                    arr = np.array(v)    # one sequential segment read
                    loaded += int(arr.nbytes)
                    promoted[k] = torch.from_numpy(arr).to(self.device) \
                        if self._storage_prefetch else arr
                if self._storage_prefetch and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                read_s = time.perf_counter() - t0
                self._sync("prefetch:pre_swap")
                with self._swap_lock:
                    for k in list(ds.columns):
                        ds.columns[k] = promoted[k]
                if self.durable is not None:
                    self.durable.io_add(bytes_read=loaded, read_s=read_s,
                                        rehydrations=1,
                                        rehydrated_bytes=loaded)
                psp.set(bytes=loaded)
        self._touch(name)
        self._maybe_evict(exclude=name)
        return True

    def _maybe_evict(self, exclude: Optional[str] = None) -> int:
        """Enforce ``memory_budget_bytes``: spill coldest-first (LRU by
        last read/install) until resident bytes fit.  Requires the durable
        tier; a memory-only store never spills."""
        if self.memory_budget_bytes is None or self.durable is None:
            return 0
        # one evictor at a time: concurrent budget-crossers skip instead of
        # queueing up to spill the same victims (the holder restores the
        # invariant for everyone)
        if not self._evict_lock.acquire(blocking=False):
            return 0
        try:
            spilled = 0
            if self.resident_bytes() > self.memory_budget_bytes:
                spilled += self._spill_retired()
            while self.resident_bytes() > self.memory_budget_bytes:
                before = self.resident_bytes()
                with self._swap_lock:
                    candidates = [(n, d.spilled)
                                  for n, d in self.datasets.items()]
                victims = sorted(
                    (n for n, is_spilled in candidates
                     if not is_spilled and n != exclude),
                    key=lambda n: self._last_access.get(n, 0))
                if not victims:
                    break
                if not self.spill(victims[0]):
                    break
                spilled += 1
                if self.resident_bytes() >= before:
                    break                # no progress (e.g. 0-size columns)
            return spilled
        finally:
            self._evict_lock.release()

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
                   strategy=partitioner.strategy) as sp:
            if self._device_resident:
                columns, counts, cmap = self._dispatch_device(
                    data, partitioner, n, seed)
            else:
                columns, counts, cmap = self._dispatch_host(
                    data, partitioner, n, seed)
            if _recording(sp):
                # a recorded span closes after the scatter it wraps
                self.synchronize()

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

    def rebucket(self, name: str) -> Tuple[StoredDataset, int]:
        """Re-layout ``name``'s current generation under a fresh
        :class:`CapacityMap` planned from its live histogram — SAME
        partitioner, so consumer elisions survive and no rows cross the
        network (a local rewrite, not a shuffle).  Publishes the result as
        a new generation via the usual atomic flip; returns
        ``(new ds, 0 bytes moved)``.  A no-op (current ds, 0) when the
        planned layout equals the current one.

        A device-resident dataset stays on its device: the valid rows are
        gathered there and scattered into the new layout with no host
        round trip; the store synchronizes before the logged latency."""
        t0 = time.perf_counter()
        with _span("store.rebucket", "store", dataset=name) as sp:
            ds = self.read(name)
            counts = np.asarray(ds.counts, np.int64)
            cmap = plan_capacity_map(counts,
                                     threshold=self.capacity_threshold)
            if cmap == ds.capacity_map:
                sp.set(noop=True)
                return ds, 0
            dev = flatten_dataset(ds, device_only=True) \
                if self._device_resident else {}
            flat = dev if len(dev) == len(ds.columns) \
                else flatten_dataset(ds)
            columns = self._materialize_layout(flat, counts, cmap,
                                               device_columns=dev or None)
            self.synchronize()
            new = StoredDataset(name=name, columns=columns, counts=counts,
                                partitioner=ds.partitioner,
                                num_rows=ds.num_rows, nbytes=ds.nbytes,
                                capacity_map=cmap)
            self._install(name, new)
            sp.set(generation=new.generation, bucketed=cmap is not None)
        self._log_write({
            "name": name, "rows": new.num_rows, "bytes": new.nbytes,
            "strategy": ds.partitioner.strategy if ds.partitioner else None,
            "latency": time.perf_counter() - t0,
            "skew": new.skew(),
            "padded_bytes": new.padded_bytes,
            "valid_bytes": new.valid_bytes,
            "bucketed": cmap is not None,
            "path": "rebucket",
            "generation": new.generation,
        })
        return new, 0

    # -- read path -------------------------------------------------------------
    def read(self, name: str,
             generation: Optional[int] = None) -> StoredDataset:
        """Current generation of ``name``; pass ``generation`` to resolve a
        specific (possibly superseded, still-retained) one.

        On a device-resident durable store, reading a spilled dataset
        prefetches it host→device first (DESIGN §10), so a reopened device
        store repartitions device to device; a host store reads straight
        through the memmap views (lazy page-in).

        Thread-safety (DESIGN §11): the current-generation hot path is
        LOCK-FREE — one dict lookup resolves an immutable StoredDataset.
        Only the retired-generation fallback briefly takes the writer lock
        to snapshot the retention list."""
        ds = self.datasets[name]
        if generation is None or ds.generation == generation:
            self._touch(name)
            if self._storage_prefetch and ds.spilled:
                self.prefetch(name)
                return self.datasets.get(name, ds)
            return ds
        with self._swap_lock:
            retained = list(self._retired.get(name, ()))
        for old in reversed(retained):
            if old.generation == generation:
                return old
        if self.durable is not None:
            # a fresh process retains no in-memory retired generations, but
            # the durable tier keeps the same retention window on disk
            old = self.durable.load(name, generation)
            if old is not None:
                return self._cluster_resident(old)
        raise RetiredGenerationError(
            f"{name}@gen{generation} not found "
            f"(current gen {ds.generation}, retains last "
            f"{self.max_retired_generations})")

    def stored_partitioners(self) -> Dict[str, Optional[PartitionerCandidate]]:
        with self._swap_lock:
            return {n: d.partitioner for n, d in self.datasets.items()}

    # -- shuffle (the operation Lachesis exists to avoid) ------------------------
    def repartition(self, ds: StoredDataset,
                    partitioner: PartitionerCandidate,
                    name: Optional[str] = None,
                    mesh=None, swap: bool = False
                    ) -> Tuple[StoredDataset, int]:
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
        to the side, then one atomic pointer flip publishes it.

        Pass ``mesh`` (a :class:`~repro_torch.core.sharding_bridge.Mesh` of
        any number of devices) to place the result on it, worker axis over
        ``"data"``, so repartitioned datasets stay mesh-placed.  A dataset
        already placed on a mesh goes shard to shard
        (:func:`~.device_repartition.sharded_repartition_dataset`: the hash
        kernel on every shard, rows copied between devices; only a bucketed
        result is assembled on the mesh's first device); an unplaced one is
        repartitioned on its
        device and placed (``sharding_bridge.device_put_dataset``).  A
        placed dataset with ``mesh=None`` is flattened onto its mesh's
        first device and comes back unplaced, as in the reference."""
        if mesh is not None:
            from ..core.sharding_bridge import device_put_dataset
        self._note_cards(mesh, ds)
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
                shard_to_shard = mesh is not None and _placed(ds)
                if shard_to_shard:
                    columns, counts, cmap = sharded_repartition_dataset(
                        ds, partitioner, self.m, mesh,
                        plan_capacity=self._plan_cmap)
                else:
                    columns, counts, cmap = device_repartition_dataset(
                        ds, partitioner, self.m,
                        plan_capacity=self._plan_cmap)
                new = StoredDataset(name=name, columns=columns, counts=counts,
                                    partitioner=partitioner,
                                    num_rows=int(counts.sum()),
                                    nbytes=ds.nbytes, capacity_map=cmap)
                if mesh is not None and not shard_to_shard:
                    new = device_put_dataset(mesh, new)
                # the histogram reached the host early; the scatter and
                # gathers may still run: the logged latency, and the
                # Autopilot's apply wall around this call, wait for them
                self.synchronize()
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
                if mesh is not None:
                    # same generation, mesh-placed columns — re-publish only
                    # if no newer generation landed while placing (CAS)
                    new = device_put_dataset(mesh, new)
                    with self._swap_lock:
                        cur = self.datasets.get(name)
                        if cur is not None \
                                and cur.generation == new.generation:
                            self.datasets[name] = new
            if _recording(rsp):
                self.synchronize()
        return new, moved
