"""Device-resident repartition path (DESIGN §5).

The paper's dispatch hot spot — hash the partition key, histogram the
destinations, re-bucket every column — runs here as a **single-pass device
shuffle**: one cached pipeline per shape bucket that hashes, counting-sorts
and permutes/scatters on the device.  Three consumers:

* the :class:`~repro_torch.data.partition_store.PartitionStore` device write
  path (:func:`device_scatter_padded` — scatter flat rows into the
  persistent ``(m, capacity, ...)`` layout),
* the executor's repartition node (:func:`device_rebucket_full` — re-bucket
  a flat intermediate into worker segments), and
* :func:`device_repartition_dataset` — the device-to-device fast path that
  reshuffles a device-resident ``StoredDataset`` into a new layout without
  a host ``gather()``, and
* :func:`sharded_repartition_dataset` — the same for a dataset placed on a
  mesh of several devices, shard to shard: every shard hashes its own rows
  and sends each destination block its run of them.

**Dispatch plans.**  A :class:`ShufflePlan` is the hash → counting-sort →
permute/scatter pipeline for one ``(shape-bucket, dtype-set, m, capacity)``
key.  Row counts are padded up to a power-of-two bucket and the valid count
rides along as a plain argument, so every N in the bucket reuses one plan;
``plan_cache_stats()["traces"]`` counts plan builds, so "flat across
repeated shuffles" still means one plan per bucket.  Same-dtype columns
are packed into a single ``(B, C)`` matrix, so K columns cost one
gather/scatter and one host copy, not K.

**Counting sort, not argsort.**  Each row's destination is its stable
counting-sort position: per-partition base offsets plus a stable rank.  Two
executions of the same math, picked by the device (``mode``):

* ``"fused"`` (CUDA default) — the ``hash_partition_padded`` kernel emits
  pids with padding routed to an overflow partition ``m``, the
  ``scatter_perm`` kernel computes the permutation, and torch gathers or
  scatters the packs on the device.
* ``"hostperm"`` (CPU default) — the permutation is computed host-side
  (numpy radix sort over small-int pids: O(N)) and only the packed gather
  runs in torch.

Bit-identical guarantee: both modes apply the same Wang hash as
``core.ir._mix_hash`` and reproduce the stable-sort order exactly — no
arithmetic touches the payload — so device results match the host numpy
path bit-for-bit.  torch holds int64 and float64 natively, so every column
(64-bit ones included) lives on the device; the reference's hybrid host
gather for 64-bit columns has no counterpart here.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.hash_partition.ops import (padded_partition_ids,
                                          partition_ids, scatter_permutation)
from ..kernels.hash_partition.ref import wang_hash
from ..obs.tracer import recording as _recording
from ..obs.tracer import span as _span
from .capacity import CapacityMap, bucket_capacity, valid_slot_index

Columns = Dict[str, Any]


# ``core``'s package imports the planner, the store and through it this
# module, so its two helpers are imported at the call: importing this
# module first then works, as the reference's does.

def resolve_device(device) -> torch.device:
    from ..core.backends import resolve_device as resolve
    return resolve(device)


def _sharded(v) -> bool:
    from ..core.sharding_bridge import ShardedColumn
    return isinstance(v, ShardedColumn)


def to_numpy(v) -> np.ndarray:
    from ..core.ir import to_numpy as convert
    return convert(v)


MODES = ("fused", "hostperm")


def _close_after_device(sp, dev) -> None:
    """A recorded span that wraps device work closes after it: wait for
    ``dev`` only when ``sp`` records (the untraced path adds no
    synchronize)."""
    if _recording(sp) and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def default_mode(device) -> str:
    return "fused" if torch.device(device).type == "cuda" else "hostperm"


def _resolve_mode(mode: Optional[str], device: torch.device) -> str:
    mode = default_mode(device) if mode is None else mode
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    return mode


def _resolve_dev(device, *values) -> torch.device:
    """The explicit ``device``, else the device of the first torch tensor
    among ``values``, else CUDA (which raises when no card is present)."""
    if device is None:
        for v in values:
            if isinstance(v, torch.Tensor):
                return v.device
            if isinstance(v, dict):
                for x in v.values():
                    if isinstance(x, torch.Tensor):
                        return x.device
        device = "cuda"
    return resolve_device(device)


def _torch_dtype(dt) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(dt))).dtype


def _np_dtype(v) -> np.dtype:
    if isinstance(v, torch.Tensor):
        return torch.empty(0, dtype=v.dtype).numpy().dtype
    return np.asarray(v).dtype


def as_kernel_keys(keys, device=None) -> torch.Tensor:
    """Normalize a key column for the hash kernel: int32 on ``device``.

    Mirrors ``core.ir._mix_hash``'s dtype handling exactly (float32 bits
    are reinterpreted, float64 is rounded to float32 first, everything else
    is cast to int32 with wrap-around) so kernel pids equal host pids
    bit-for-bit.  Device-resident keys are normalized on their device — no
    host round-trip."""
    if isinstance(keys, torch.Tensor):
        k = keys.reshape(-1)
        if device is not None:
            k = k.to(resolve_device(device))
        if k.dtype == torch.float64:
            k = k.to(torch.float32)
        if k.dtype == torch.float32:
            return k.contiguous().view(torch.int32)
        return k.to(torch.int32).contiguous()
    k = torch.from_numpy(np.ascontiguousarray(_host_kernel_keys(keys)))
    return k.to(_resolve_dev(device))


def _host_kernel_keys(keys) -> np.ndarray:
    """Host-side twin of :func:`as_kernel_keys` (int32, same truncation)."""
    k = np.asarray(keys).reshape(-1)
    if np.issubdtype(k.dtype, np.integer) or k.dtype == np.bool_:
        return k.astype(np.int32)
    if k.dtype == np.float64:
        k = k.astype(np.float32)
    if k.dtype == np.float32:
        return k.view(np.int32)
    return k.astype(np.int32)


def _host_wang(x: np.ndarray) -> np.ndarray:
    """Numpy twin of ref.wang_hash — identical uint32 arithmetic."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint32)
        x = (x ^ np.uint32(61)) ^ (x >> np.uint32(16))
        x = x * np.uint32(9)
        x = x ^ (x >> np.uint32(4))
        x = x * np.uint32(0x27D4EB2D)
        x = x ^ (x >> np.uint32(15))
    return x


def device_partition_ids(keys, num_partitions: int, *, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel dispatch: keys → (pids (N,) int32, histogram (m,) int32) on
    ``device`` (default: the keys' device, else CUDA)."""
    keys = as_kernel_keys(keys, _resolve_dev(device, keys))
    return partition_ids(keys, num_partitions)


def shuffle_pids(keys, num_partitions: int, *, mode: Optional[str] = None,
                 device=None) -> Tuple[Any, np.ndarray]:
    """Mode-matched pid computation: ``(pids, counts (m,) np.int64)``.

    fused → kernel hash + histogram on the device (pids stay there);
    hostperm → torch keys hash with the torch twin on their own device,
    host keys with the numpy Wang twin; histogram via np.bincount."""
    dev = _resolve_dev(device, keys)
    mode = _resolve_mode(mode, dev)
    if mode == "fused":
        pids, hist = device_partition_ids(keys, num_partitions, device=dev)
        return pids, hist.cpu().numpy().astype(np.int64)
    if isinstance(keys, torch.Tensor):
        h = wang_hash(as_kernel_keys(keys)) % num_partitions
        pids = h.to(torch.int32).cpu().numpy()
    else:
        pids = (_host_wang(_host_kernel_keys(keys))
                % np.uint32(num_partitions)).astype(np.int32)
    counts = np.bincount(pids, minlength=num_partitions).astype(np.int64)
    return pids, counts


# ---------------------------------------------------------------------------
# Host counting-sort placement (shared with the store's host dispatch)
# ---------------------------------------------------------------------------

def host_counting_order(pids: np.ndarray) -> np.ndarray:
    """Stable order of rows grouped by pid — numpy radix sort (O(N)) when
    the pids fit in int16, stable mergesort otherwise.  Identical output to
    ``np.argsort(pids, kind="stable")`` either way."""
    if pids.size and pids.max(initial=0) < np.iinfo(np.int16).max:
        return np.argsort(pids.astype(np.int16), kind="stable")
    return np.argsort(pids, kind="stable")


def host_counting_sort_dest(pids: np.ndarray, counts: np.ndarray,
                            cap: int,
                            dest_offsets: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """Flat destination slot (partition base + stable rank-within-pid) of
    every row — one vectorized counting-sort placement shared by all
    columns.  The uniform layout's base is ``pid * cap``; a bucketed layout
    passes its own per-partition ``dest_offsets``."""
    n = pids.shape[0]
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = host_counting_order(pids)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n, dtype=np.int64) - offsets[pids[order]]
    if dest_offsets is None:
        return pids * cap + rank
    return np.asarray(dest_offsets, dtype=np.int64)[pids] + rank


# ---------------------------------------------------------------------------
# Shape buckets and column packing
# ---------------------------------------------------------------------------

def shape_bucket(n: int) -> int:
    """Pad row counts up to a power of two so nearby Ns share one plan."""
    return max(8, 1 << (int(n) - 1).bit_length())


@dataclass
class _Pack:
    """Same-dtype columns flattened into one (rows, C) matrix — one upload
    + one gather/scatter + one download per dtype."""
    dtype: np.dtype
    width: int                                   # C = sum of member widths
    members: List[Tuple[str, Tuple[int, ...], int, int]]  # name, trail, c0, c1
    data: Optional[torch.Tensor] = None          # (rows, C) on the device


def _source_columns(columns: Columns,
                    device_columns: Optional[Columns] = None
                    ) -> List[Tuple[str, Any]]:
    """Every column, preferring the device-resident copy from
    ``device_columns`` so an upstream device stage's output feeds the next
    shuffle without re-uploading."""
    out = []
    for k, v in columns.items():
        if device_columns is not None and k in device_columns:
            v = device_columns[k]
        out.append((k, v if isinstance(v, torch.Tensor) else np.asarray(v)))
    return out


def _build_packs(cols: List[Tuple[str, Any]], n: int, rows: int,
                 device: torch.device) -> List[_Pack]:
    """Group columns by dtype into (rows, C) pack matrices on ``device``;
    rows beyond n are zero padding (never read back)."""
    groups: Dict[str, _Pack] = {}
    for name, v in cols:
        dt = _np_dtype(v)
        trail = tuple(v.shape[1:])
        w = int(np.prod(trail)) if trail else 1
        p = groups.setdefault(str(dt), _Pack(dtype=dt, width=0, members=[]))
        p.members.append((name, trail, p.width, p.width + w))
        p.width += w
    packs = sorted(groups.values(), key=lambda p: str(p.dtype))
    by_name = dict(cols)
    for p in packs:
        if any(isinstance(by_name[nm], torch.Tensor) for nm, *_ in p.members):
            # assemble on the device — no host round-trip
            data = torch.zeros((rows, p.width), dtype=_torch_dtype(p.dtype),
                               device=device)
            for nm, _trail, c0, c1 in p.members:
                data[:n, c0:c1] = torch.as_tensor(by_name[nm]).to(
                    device).reshape(n, -1)
        else:
            buf = np.zeros((rows, p.width), p.dtype)
            for nm, _trail, c0, c1 in p.members:
                buf[:n, c0:c1] = by_name[nm].reshape(n, -1)
            data = torch.from_numpy(buf).to(device)        # one upload
        p.data = data
    return packs


def _pack_spec(packs: List[_Pack]) -> Tuple[Tuple[str, int], ...]:
    return tuple((str(p.dtype), p.width) for p in packs)


# ---------------------------------------------------------------------------
# ShufflePlan: the permute/scatter pipelines, cached per shape bucket
# ---------------------------------------------------------------------------

@dataclass
class ShufflePlan:
    """One cached dispatch plan, keyed on
    (kind, m, shape-bucket, [row-bucket,] dtype-set, mode)."""
    key: Tuple
    fn: Callable = None
    traces: int = 0          # plan builds (1 per plan; the no-rebuild count)
    calls: int = 0


# LRU-bounded plan cache.  A long-lived session shuffles many
# (shape-bucket, dtype-set, m, capacity) keys over its lifetime.
# Least-recently-used plans are evicted past the capacity; their
# build/call counters fold into ``_RETIRED`` so ``plan_cache_stats()``
# totals stay monotone across evictions.
_PLANS: "OrderedDict[Tuple, ShufflePlan]" = OrderedDict()
_PLAN_CACHE_CAPACITY = 64
_RETIRED = {"plans": 0, "traces": 0, "calls": 0}
# Guards _PLANS/_RETIRED: shuffles may be dispatched from many threads; an
# unguarded OrderedDict corrupts under concurrent get/move_to_end/popitem.
_PLANS_LOCK = threading.RLock()


def plan_cache_stats() -> Dict[str, int]:
    """(plans, traces, calls, evictions) across the process — ``plans`` is
    the live-plan count; ``traces`` (plan builds) and ``calls`` include
    evicted plans, so a flat ``traces`` across repeated same-shape shuffles
    stays the one-plan-per-bucket guarantee even after LRU turnover."""
    with _PLANS_LOCK:
        return {"plans": len(_PLANS),
                "traces": sum(p.traces for p in _PLANS.values())
                + _RETIRED["traces"],
                "calls": sum(p.calls for p in _PLANS.values())
                + _RETIRED["calls"],
                "evictions": _RETIRED["plans"]}


def clear_plan_cache() -> None:
    """Drop every plan and all counters (tests start from a clean slate)."""
    with _PLANS_LOCK:
        _PLANS.clear()
        _RETIRED.update(plans=0, traces=0, calls=0)


def _evict_to_capacity() -> None:
    # caller holds _PLANS_LOCK
    while len(_PLANS) > _PLAN_CACHE_CAPACITY:
        _key, plan = _PLANS.popitem(last=False)
        _RETIRED["plans"] += 1
        _RETIRED["traces"] += plan.traces
        _RETIRED["calls"] += plan.calls


def _get_plan(key: Tuple, build: Callable[[], Callable]) -> ShufflePlan:
    # keyed by shape, not device: a plan's function holds no tensor (it
    # allocates on its inputs' device), so the shards of a mesh share it
    with _PLANS_LOCK:
        plan = _PLANS.get(key)
        if plan is None:
            plan = ShufflePlan(key=key, fn=build(), traces=1)
            _PLANS[key] = plan
            _evict_to_capacity()
        else:
            _PLANS.move_to_end(key)
        plan.calls += 1
        return plan


def _fused_rebucket_plan(m: int, B: int, spec: Tuple) -> ShufflePlan:
    """keys + valid count + packs → (order, counts, gathered packs): hash
    kernel (padding → overflow partition m) → counting-sort kernel →
    permutation inversion → packed gather."""
    def build():
        def fn(keys, n, packs):
            pids, counts_full = padded_partition_ids(keys, n, m)
            dest = scatter_permutation(pids, counts_full)
            # invert the counting-sort placement → gather permutation
            order = torch.empty_like(dest)
            order[dest] = torch.arange(B, dtype=torch.int32,
                                       device=dest.device)
            outs = tuple(p.index_select(0, order) for p in packs)
            return order, counts_full[:m], outs
        return fn

    return _get_plan(("rebucket", m, B, spec, "fused"), build)


def _hostperm_rebucket_plan(m: int, B: int, spec: Tuple) -> ShufflePlan:
    """host-computed counting-sort order + packs → gathered packs."""
    def build():
        def fn(order, packs):
            return tuple(p.index_select(0, order) for p in packs)
        return fn

    return _get_plan(("rebucket", m, B, spec, "hostperm"), build)


def _fused_scatter_plan(m: int, B: int, R: int, spec: Tuple) -> ShufflePlan:
    """pids + full counts + per-partition slot adjustments + packs → flat
    (R, C) packs.

    The per-partition slot bases ride along as an ``(m,)`` tensor and the
    output rows are bucketed to ``R ≥ total slots`` (+1 trash slot), so
    same-shape writes with different key skew — and uniform vs bucketed
    :class:`CapacityMap` layouts alike — reuse one plan; the caller slices
    ``[:total]``.  ``slot_adj[p]`` is partition p's first slot minus its
    first counting-sort position, so ``slot_adj[pid] + dest`` is the row's
    slot."""
    def build():
        def fn(pids, counts_full, slot_adj, packs):
            dest = scatter_permutation(pids, counts_full)
            # real rows → their slot; padding rows (pid == m) → the trash
            # slot R (the clamped lookup is discarded by the where)
            base = slot_adj[torch.clamp_max(pids, m - 1)]
            flat_dest = torch.where(pids < m, base + dest, R)
            outs = []
            for p in packs:
                buf = torch.zeros((R + 1, p.shape[1]), dtype=p.dtype,
                                  device=p.device)
                # Every padding row writes slot R.  With duplicate indices
                # CUDA's index_put_ keeps an arbitrary writer, so slot R
                # holds nondeterministic bits: harmless only because row R
                # is sliced off below and never read.
                buf[flat_dest] = p
                outs.append(buf[:R])
            return flat_dest, tuple(outs)
        return fn

    return _get_plan(("scatter", m, B, R, spec, "fused"), build)


def _hostperm_scatter_plan(m: int, B: int, R: int,
                           spec: Tuple) -> ShufflePlan:
    """Gather-formulated padded scatter: ``inv`` maps every (worker, slot)
    to its source row (B = the all-zeros trash row for empty slots), so the
    layout materializes as one packed gather.  Output rows are bucketed to
    ``R ≥ m * cap`` so different capacities share one plan."""
    def build():
        def fn(inv, packs):
            return tuple(p.index_select(0, inv) for p in packs)
        return fn

    return _get_plan(("scatter", m, B, R, spec, "hostperm"), build)


# ---------------------------------------------------------------------------
# Re-bucket (executor repartition node)
# ---------------------------------------------------------------------------

@dataclass
class ShuffleResult:
    """Output of a device shuffle: host-materialized columns for the
    executor's columnar compute plus the device-resident flats so a chained
    device stage (store write, next shuffle) skips the re-upload."""
    columns: Columns                     # np columns incl "__key__"
    counts: np.ndarray                   # (m,) int64
    device_columns: Optional[Columns] = None    # flat torch tensors


def device_rebucket_full(columns: Columns, key_vals, num_partitions: int, *,
                         mode: Optional[str] = None, device=None,
                         device_columns: Optional[Columns] = None
                         ) -> ShuffleResult:
    """Re-bucket flat columns by hash(key) % m through one cached plan.

    Single-pass shuffle (hash → histogram → counting-sort permutation →
    packed gather); K same-dtype columns cost one gather and one host copy.
    ``device_columns`` (flat torch tensors from an upstream device stage)
    are consumed in place of re-uploading the matching host columns.  The
    copy of the results to the host synchronizes with the device, so a
    wall clock read after this call covers the device work.
    """
    dev = _resolve_dev(device, key_vals, device_columns)
    mode = _resolve_mode(mode, dev)
    key_arr = key_vals if isinstance(key_vals, torch.Tensor) \
        else np.asarray(key_vals).reshape(-1)
    n = int(key_arr.shape[0])
    m = int(num_partitions)
    if n == 0:
        out = {k: np.asarray(v).copy() for k, v in columns.items()}
        out["__key__"] = to_numpy(key_arr)
        return ShuffleResult(out, np.zeros(m, np.int64), None)

    cols = dict(columns)
    cols["__key__"] = key_arr
    if device_columns:
        # a relayed "__key__" is the *previous* shuffle's key — never let it
        # shadow the key this node is partitioning on
        device_columns = {k: v for k, v in device_columns.items()
                          if k != "__key__"}
        if isinstance(key_arr, torch.Tensor):
            device_columns["__key__"] = key_arr
    B = shape_bucket(n)
    packs = _build_packs(_source_columns(cols, device_columns), n, B, dev)
    spec = _pack_spec(packs)

    with _span("shuffle.dispatch", "shuffle", op="rebucket", rows=n, m=m,
               bucket=B, mode=mode) as sp:
        if mode == "fused":
            keys_p = torch.zeros(B, dtype=torch.int32, device=dev)
            keys_p[:n] = as_kernel_keys(key_arr, dev)
            plan = _fused_rebucket_plan(m, B, spec)
            order_d, counts_d, outs_d = plan.fn(
                keys_p, n, tuple(p.data for p in packs))
            order_valid = order_d[:n].cpu().numpy()
            counts_np = counts_d.cpu().numpy().astype(np.int64)
        else:
            pids_np, counts_np = shuffle_pids(key_arr, m, mode="hostperm",
                                              device=dev)
            order_valid = host_counting_order(pids_np)
            order_p = np.concatenate(
                [order_valid, np.arange(n, B)]).astype(np.int32)
            plan = _hostperm_rebucket_plan(m, B, spec)
            outs_d = plan.fn(torch.from_numpy(order_p).to(dev),
                             tuple(p.data for p in packs))
        outs_np = [o.cpu().numpy() for o in outs_d]
        _close_after_device(sp, dev)

    out: Columns = {}
    device_out: Columns = {}
    for p, mat_d, mat_np in zip(packs, outs_d, outs_np):
        for name, trail, c0, c1 in p.members:
            out[name] = np.ascontiguousarray(
                mat_np[:n, c0:c1]).reshape((n,) + trail)
            device_out[name] = mat_d[:n, c0:c1].reshape((n,) + trail)
    return ShuffleResult(out, counts_np, device_out or None)


# ---------------------------------------------------------------------------
# Padded scatter (store write path)
# ---------------------------------------------------------------------------

def _check_overflow(counts_np: np.ndarray, capacities: np.ndarray) -> None:
    """Raise a diagnosable error when any partition outgrows its capacity
    (the scatter would silently clamp/drop the overflowing rows)."""
    over = np.flatnonzero(counts_np > capacities)
    if over.size:
        pid = int(over[int(np.argmax((counts_np - capacities)[over]))])
        need = int(counts_np[pid])
        have = int(capacities[pid])
        raise ValueError(
            f"partition {pid} has {need} rows but capacity {have}: the "
            f"scatter would silently drop/clamp overflowing rows "
            f"(suggest overflow bucket capacity {bucket_capacity(need)} "
            f"for partition {pid}, e.g. via CapacityMap.from_counts)")


def device_scatter_padded(flat_columns: Columns, pids, counts, *,
                          capacity: Optional[int] = None,
                          capacity_map: Optional[CapacityMap] = None,
                          mode: Optional[str] = None, device=None,
                          device_columns: Optional[Columns] = None
                          ) -> Columns:
    """Scatter flat rows into the persistent padded layout on the device.

    Uniform layout (default): ``(m, capacity, ...)`` columns.  With a
    ``capacity_map``, each partition gets its own slot range and columns
    come back *flat* as ``(total_slots, ...)`` — partition ``i`` occupies
    ``[offsets[i], offsets[i] + capacities[i])``.  Both shapes ride the
    same cached plan: the per-partition slot bases are a tensor argument,
    so switching skew levels (or uniform ↔ bucketed within one output-row
    bucket) never builds a new plan.

    The destination slot of row i is ``base[pids[i]] + rank-of-i-within-
    its-partition``, materialized per dtype *pack* — K same-dtype columns
    cost one scatter.  Every column comes back as a torch tensor on the
    device.

    A ``capacity`` (or capacity-map bucket) smaller than its partition's
    row count would silently clamp/drop rows inside the scatter, so it
    raises instead, naming the offending partition.
    """
    dev = _resolve_dev(device, pids, device_columns, flat_columns)
    mode = _resolve_mode(mode, dev)
    counts_np = np.asarray(counts).astype(np.int64)
    m = int(counts_np.shape[0])
    n = int(counts_np.sum())
    max_count = int(counts_np.max()) if n else 0
    if capacity_map is not None:
        if capacity is not None:
            raise ValueError("pass capacity or capacity_map, not both")
        if capacity_map.num_partitions != m:
            raise ValueError(
                f"capacity_map covers {capacity_map.num_partitions} "
                f"partitions, counts cover {m}")
        _check_overflow(counts_np, capacity_map.capacities)
        offsets_np = capacity_map.offsets.astype(np.int64)
        total = capacity_map.total_slots
        cap = 0
    else:
        if capacity is not None and int(capacity) < max_count:
            _check_overflow(counts_np,
                            np.full(m, int(capacity), dtype=np.int64))
        cap = int(capacity) if capacity is not None else max_count
        offsets_np = np.arange(m, dtype=np.int64) * cap
        total = m * cap

    def _shape(trail: Tuple[int, ...]) -> Tuple[int, ...]:
        if capacity_map is not None:
            return (total,) + trail
        return (m, cap) + trail

    if n == 0:
        if capacity_map is None:
            cap = cap or 1
        return {k: torch.zeros(_shape(tuple(v.shape[1:])),
                               dtype=_torch_dtype(_np_dtype(v)), device=dev)
                for k, v in flat_columns.items()}

    cols = _source_columns(flat_columns, device_columns)
    B = shape_bucket(n)
    R = shape_bucket(total)  # output-row bucket: bases are data, not keys

    with _span("shuffle.dispatch", "shuffle", op="scatter", rows=n, m=m,
               bucket=B, mode=mode) as sp:
        if mode == "fused":
            packs = _build_packs(cols, n, B, dev)
            pids_p = torch.full((B,), m, dtype=torch.int32, device=dev)
            pids_p[:n] = torch.as_tensor(pids).to(dev, torch.int32)
            counts_full = np.append(counts_np, B - n).astype(np.int32)
            starts = np.concatenate([[0], np.cumsum(counts_np)[:-1]])
            slot_adj = offsets_np - starts
            plan = _fused_scatter_plan(m, B, R, _pack_spec(packs))
            _flat_dest, outs = plan.fn(
                pids_p, torch.from_numpy(counts_full).to(dev),
                torch.from_numpy(slot_adj).to(dev),
                tuple(p.data for p in packs))
        else:
            # rows [n:B] of each pack are zeros; row B is the explicit trash
            # source every empty (worker, slot) cell gathers from
            packs = _build_packs(cols, n, B + 1, dev)
            pids_np = to_numpy(pids).astype(np.int64)
            flat_dest_np = host_counting_sort_dest(pids_np, counts_np, cap,
                                                   dest_offsets=offsets_np)
            inv = np.full(R, B, np.int32)
            inv[flat_dest_np] = np.arange(n, dtype=np.int32)
            plan = _hostperm_scatter_plan(m, B, R, _pack_spec(packs))
            outs = plan.fn(torch.from_numpy(inv).to(dev),
                           tuple(p.data for p in packs))
        _close_after_device(sp, dev)

    columns: Columns = {}
    for p, mat in zip(packs, outs):
        flat = mat[:total]
        for name, trail, c0, c1 in p.members:
            columns[name] = flat[:, c0:c1].reshape(_shape(trail))
    return columns


# ---------------------------------------------------------------------------
# Device-to-device dataset repartition (store fast path)
# ---------------------------------------------------------------------------

def _valid_slot_index(ds) -> np.ndarray:
    """Flat indices of the valid slots of a padded layout in worker-major
    order — the exact row order ``StoredDataset.gather()`` produces.
    Single source of truth for every flatten below (the bit-identical
    guarantee hangs on this ordering).  Uniform layouts use base offsets
    ``w * capacity``; bucketed layouts use their :class:`CapacityMap`
    offsets — the enumerated row order is identical either way.
    """
    counts = np.asarray(ds.counts)
    cm = getattr(ds, "capacity_map", None)
    if cm is not None:
        offs = cm.offsets
    else:
        offs = np.arange(ds.num_workers, dtype=np.int64) * ds.capacity
    return valid_slot_index(counts, offs)


def _flat_slots(ds, v):
    """A column viewed as flat slots: bucketed columns already are
    ``(total_slots, ...)``; uniform ``(m, capacity, ...)`` columns
    reshape."""
    if getattr(ds, "capacity_map", None) is not None:
        return v
    return v.reshape((ds.num_workers * ds.capacity,) + tuple(v.shape[2:]))


def _block_valid_index(ds, sl: slice) -> np.ndarray:
    """The valid slots of the block of ``ds``'s leading axis that ``sl``
    covers, as flat indices into that block, worker-major: the block's own
    slice of :func:`_valid_slot_index`, less the block's first slot.  A
    bucketed column is one block over every slot."""
    if getattr(ds, "capacity_map", None) is not None:
        return _valid_slot_index(ds)
    counts = np.asarray(ds.counts)[sl]
    return valid_slot_index(
        counts, np.arange(counts.shape[0], dtype=np.int64) * ds.capacity)


def flatten_blocks(ds, columns: Columns) -> Dict[str, List[torch.Tensor]]:
    """The valid rows of each block of every sharded column in
    ``columns`` (``core.sharding_bridge.ShardedColumn``\\ s of ``ds``),
    flat and on the block's own device, in block order: concatenated, the
    worker-major order ``StoredDataset.gather()`` gives.  Each block's
    index goes to its device once for all columns."""
    idx_dev: Dict[Tuple[int, torch.device], torch.Tensor] = {}
    out: Dict[str, List[torch.Tensor]] = {}
    for k, v in columns.items():
        rows = []
        for sl, t in v.blocks():
            key = (sl.start, t.device)
            if key not in idx_dev:
                idx_dev[key] = torch.from_numpy(
                    _block_valid_index(ds, sl)).to(t.device)
            flat = t if getattr(ds, "capacity_map", None) is not None \
                else t.reshape((-1,) + tuple(t.shape[2:]))
            rows.append(flat.index_select(0, idx_dev[key]))
        out[k] = rows
    return out


def flatten_dataset(ds, device_only: bool = False) -> Columns:
    """Flatten a StoredDataset's padded columns back to flat rows *without*
    a host round-trip: device-resident columns are gathered with a device
    index over :func:`_valid_slot_index`; a column placed on a mesh is
    gathered shard by shard (:func:`flatten_blocks`) onto the mesh's first
    device, a whole-column read that ``core.sharding_bridge.WHOLE_READS``
    counts; host columns take the numpy path (skipped entirely under
    ``device_only``).
    """
    from ..core.sharding_bridge import count_whole_read
    blocks = flatten_blocks(ds, {k: v for k, v in ds.columns.items()
                                 if _sharded(v)})
    idx = None
    idx_dev: Dict[torch.device, torch.Tensor] = {}
    out: Columns = {}
    for k, v in ds.columns.items():
        if k in blocks:
            count_whole_read()
            first = v.sharding.mesh.devices.flat[0]
            out[k] = torch.cat([b.to(first) for b in blocks[k]])
            continue
        if idx is None and (isinstance(v, torch.Tensor) or not device_only):
            idx = _valid_slot_index(ds)
        if isinstance(v, torch.Tensor):
            if v.device not in idx_dev:
                idx_dev[v.device] = torch.from_numpy(idx).to(v.device)
            out[k] = _flat_slots(ds, v).index_select(0, idx_dev[v.device])
        elif not device_only:
            out[k] = _flat_slots(ds, np.asarray(v))[idx]
    return out


def device_flat_columns(ds) -> Optional[Columns]:
    """The device-resident subset of :func:`flatten_dataset` (a scan seeds
    its d2d chain with these), computed without touching host cols."""
    return flatten_dataset(ds, device_only=True) or None


def device_repartition_dataset(ds, partitioner, num_partitions: int, *,
                               mode: Optional[str] = None,
                               plan_capacity: Optional[Callable] = None
                               ) -> Tuple[Columns, np.ndarray,
                                          Optional[CapacityMap]]:
    """Device-to-device repartition: device-resident StoredDataset → new
    padded device layout, no host gather/concatenate.

    Valid rows are gathered on the device, the partition key is evaluated
    with the candidate's compiled key projection (torch — stays on the
    device), and the cached plan scatters straight into the new padded
    layout.  Only the histogram crosses to the host (it sizes the
    capacity).

    ``plan_capacity`` (counts → Optional[CapacityMap]) lets the store
    choose a bucketed layout from the fresh histogram; returns the map it
    used (None ⇒ uniform ``(m, capacity, ...)``).
    """
    flat = flatten_dataset(ds)
    dev = _resolve_dev(None, flat)
    keys = partitioner.key_fn()(flat)
    pids, counts = shuffle_pids(keys, num_partitions, mode=mode, device=dev)
    cmap = plan_capacity(counts) if plan_capacity is not None else None
    columns = device_scatter_padded(flat, pids, counts, capacity_map=cmap,
                                    mode=mode, device=dev)
    return columns, counts, cmap


def _pid_order(pids, hist: np.ndarray, mode: str,
               device: torch.device) -> torch.Tensor:
    """The stable order of rows by pid on ``device``: fused — the
    ``scatter_perm`` kernel's counting-sort destinations, inverted;
    hostperm — the numpy radix sort of host pids."""
    if mode == "fused":
        dest = scatter_permutation(
            pids, torch.from_numpy(hist.astype(np.int32)).to(device))
        order = torch.empty_like(dest)
        order[dest] = torch.arange(dest.numel(), dtype=torch.int32,
                                   device=device)
        return order
    return torch.from_numpy(host_counting_order(to_numpy(pids))).to(device)


def _cat_pids(pids: List[Any], device: torch.device):
    """Per-source pids (device tensors, or host arrays in hostperm mode)
    concatenated in source order, on ``device`` or on the host."""
    if any(isinstance(p, torch.Tensor) for p in pids):
        return torch.cat([torch.as_tensor(p).to(device) for p in pids])
    return np.concatenate(pids)


def sharded_repartition_dataset(ds, partitioner, num_partitions: int, mesh,
                                data_axes: Tuple[str, ...] = ("data",),
                                plan_capacity: Optional[Callable] = None, *,
                                mode: Optional[str] = None,
                                on_step: Optional[Callable] = None
                                ) -> Tuple[Columns, np.ndarray,
                                           Optional[CapacityMap]]:
    """Shard-to-shard repartition of a dataset placed on a mesh (every
    column a ``core.sharding_bridge.ShardedColumn``) into a new layout
    placed on ``mesh``, worker axis over ``data_axes``.

    (a) On each source block's device: flatten its valid rows
    (:func:`flatten_blocks`), evaluate the candidate's key projection and
    hash it (:func:`shuffle_pids`: the ``hash_partition`` kernel, global
    pids over ``m`` and the block's histogram).  (b) The histograms are
    summed on the host, the only host crossing, as on one device;
    ``plan_capacity(counts)`` picks uniform or bucketed as on one device.
    (c) Uniform: each source orders its rows by pid (the stable
    ``scatter_perm`` over ``m`` bins), so destination block ``j``'s rows
    are one contiguous run, copied to ``j``'s device.  (d) Each destination
    concatenates its runs in source order and scatters them
    (:func:`device_scatter_padded`: ``scatter_perm`` again) into ``(m /
    extent, capacity, ...)`` with local pids ``p - j * m / extent`` and the
    global ``capacity = max(counts)``, so every block has the shape the
    single-device layout's rows would have.  With one destination block no
    source needs ordering: its runs are its rows.

    Row order (the bit-identical guarantee, DESIGN §5 / Alg. 4's
    elision, rests on it): the sources hold contiguous worker blocks in
    rank order, and every step is stable — the order by pid, the
    concatenation in source order, the counting sort of the scatter — so
    each worker's rows land in the order a single-device repartition of
    ``gather()``'s rows gives them, which is the reference's.

    (e) Bucketed: a capacity map spans every partition, so the shards are
    flattened onto the mesh's first device in worker order (counted in
    ``core.sharding_bridge.WHOLE_READS``) and scattered there with the
    pids already computed; the columns come back placed ``P()``,
    replicated on every mesh position, as the reference's bucketed result
    of a placed dataset is.  ``mesh=None``
    takes the single-device path (:func:`device_repartition_dataset`,
    which flattens the same way) and returns plain tensors.

    Each launch runs on the current stream of its own device (the
    launchers enter the tensor's device); a copy between devices waits on
    both devices' current streams, so a destination never reads a run
    before its copy lands.  ``on_step(name, info)``, if given, is called
    after each step ("sources", with the ``(n_src, m)`` histograms in
    ``info["histograms"]``; "copies"; "destinations") — a caller that
    records CUDA events there times each step."""
    from ..core.sharding_bridge import (NamedSharding, P, ShardedColumn,
                                        block_devices, count_whole_read,
                                        sharding_for)
    m = int(num_partitions)
    if mesh is None:
        return device_repartition_dataset(ds, partitioner, m, mode=mode,
                                          plan_capacity=plan_capacity)
    extent = int(np.prod([mesh.shape[a] for a in data_axes]))
    if m % extent:
        raise ValueError(f"m={m} not divisible by mesh data extent {extent}")
    if not ds.columns or not all(_sharded(v)
                                 for v in ds.columns.values()):
        raise ValueError("every column must be placed on a mesh")
    step = on_step or (lambda name, info: None)
    names = list(ds.columns)
    first_col = ds.columns[names[0]]
    src_dev = [t.device for _, t in first_col.blocks()]
    src = flatten_blocks(ds, ds.columns)
    pids: List[Any] = []
    hists: List[np.ndarray] = []
    for s, dev in enumerate(src_dev):
        flat = {k: src[k][s] for k in names}
        if flat[names[0]].shape[0] == 0:
            pids.append(np.zeros(0, np.int32))
            hists.append(np.zeros(m, np.int64))
            continue
        p, c = shuffle_pids(partitioner.key_fn()(flat), m, mode=mode,
                            device=dev)
        pids.append(p)
        hists.append(c)
    counts = np.sum(hists, axis=0).astype(np.int64)
    cmap = plan_capacity(counts) if plan_capacity is not None else None
    if cmap is not None:
        first = mesh.devices.flat[0]
        flat = {}
        for k in names:
            count_whole_read()
            flat[k] = torch.cat([b.to(first) for b in src[k]])
        columns = device_scatter_padded(flat, _cat_pids(pids, first),
                                        counts, capacity_map=cmap,
                                        mode=mode, device=first)
        whole = NamedSharding(mesh, P())
        return ({k: ShardedColumn(whole, [v]) for k, v in columns.items()},
                counts, cmap)

    dst_dev = block_devices(sharding_for(mesh, partitioner, data_axes))
    w = m // len(dst_dev)
    cap = int(counts.max()) if counts.sum() else 0
    # runs[j][s]: source s's rows bound for destination block j
    runs: List[List[Columns]] = [[] for _ in dst_dev]
    for s, dev in enumerate(src_dev):
        rows = {k: src[k][s] for k in names}
        if len(dst_dev) > 1 and rows[names[0]].shape[0]:
            order = _pid_order(pids[s], hists[s],
                               _resolve_mode(mode, dev), dev)
            rows = {k: v.index_select(0, order) for k, v in rows.items()}
        bounds = np.concatenate([[0], np.cumsum(hists[s])])
        for j in range(len(dst_dev)):
            a, b = int(bounds[j * w]), int(bounds[(j + 1) * w])
            runs[j].append({k: v[a:b] for k, v in rows.items()})
    step("sources", {"histograms": np.stack(hists)})
    arrived = [[{k: v.to(dst_dev[j]) for k, v in run.items()}
                for run in runs[j]] for j in range(len(dst_dev))]
    step("copies", {})
    blocks: Dict[str, List[torch.Tensor]] = {k: [] for k in names}
    for j, dev in enumerate(dst_dev):
        local = np.stack([h[j * w:(j + 1) * w] for h in hists])  # (n_src, w)
        n_j = int(local.sum())
        flat = {k: torch.cat([run[k] for run in arrived[j]]) for k in names}
        if len(dst_dev) == 1:            # the runs are the unordered rows
            local_pids = _cat_pids(pids, dev)
        else:
            # each source's run is ordered by pid: its local pids repeat
            # 0..w-1 by the source's counts
            local_pids = torch.repeat_interleave(
                torch.arange(w, dtype=torch.int32, device=dev).repeat(
                    len(src_dev)),
                torch.from_numpy(local.reshape(-1)).to(dev), output_size=n_j)
        cols = device_scatter_padded(flat, local_pids, local.sum(axis=0),
                                     capacity=cap, mode=mode, device=dev)
        for k in names:
            blocks[k].append(cols[k])
    step("destinations", {})
    return ({k: ShardedColumn(sharding_for(mesh, partitioner, data_axes,
                                           extra_dims=v[0].dim() - 2), v)
             for k, v in blocks.items()}, counts, None)
