"""Executor — runs a frozen :class:`~repro_torch.core.planner.PhysicalPlan`.

The second half of the planner/executor split (DESIGN §9).  All per-node
*policy* — candidate extraction, Alg. 4 elision, backend-op binding — was
decided at plan time; the executor is a thin loop over the plan's bound
steps that only carries values, measures stats, and fires observation
hooks.  Join, aggregate and filter run columnar in numpy on the host, as
in the reference; key projections and the device re-bucket use torch.

The per-candidate measurement pass (selectivity / distinct keys at every
partition node — an ``np.unique`` over the key column) is **gated** behind
observation: it only runs when at least one run hook is attached, and
``EngineStats.candidate_measure_passes`` counts it so tests can assert the
skip.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..data.device_repartition import device_flat_columns, \
    device_rebucket_full
from ..data.partition_store import RetiredGenerationError
from ..data.skew import HeavyHitterSketch
from ..obs.tracer import span as _span
from .ir import _mix_hash, resolve_fn, to_numpy

Columns = Dict[str, np.ndarray]


class StalePlanError(RuntimeError):
    """A PhysicalPlan was executed against a store whose layout generation
    no longer matches the one the plan was compiled (and its shuffles were
    statically elided) against.  Re-plan — ``Session.run`` does this
    automatically (:func:`plan_and_execute`); only direct
    ``Executor.execute`` calls see this error."""


@dataclass
class TableVal:
    """A set-valued intermediate: flat columns + per-worker segmentation.

    ``device_columns`` is the device-to-device relay (DESIGN §5): flat
    torch-tensor copies of (a subset of) ``columns`` left on device by a scan
    of a device-backed dataset or by a device repartition.  Row-preserving
    nodes pass it through; the next device stage (repartition, store write)
    consumes it instead of re-uploading the host columns.  Any row-changing
    op (join, aggregate, filter, flatten, map) drops it."""
    columns: Columns
    counts: np.ndarray                       # (m,) rows per worker segment
    partitioner: Optional[Any] = None        # current PartitionerCandidate
    device_columns: Optional[Columns] = None          # flat torch tensors

    @property
    def num_rows(self) -> int:
        return int(self.counts.sum())

    @property
    def m(self) -> int:
        return int(self.counts.shape[0])

    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.counts)[:-1]]).astype(np.int64)

    def worker_slice(self, w: int) -> Columns:
        o = self.offsets()
        return {k: v[o[w]:o[w] + self.counts[w]] for k, v in self.columns.items()}

    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self.columns.values()))


@dataclass
class EngineStats:
    """Per-run execution stats (the ExecutionRecord measurement source).

    Kept under its historical name — it is the schema every run hook,
    observer, and benchmark consumes — but now produced by the Executor."""
    shuffles_elided: int = 0
    shuffles_performed: int = 0
    shuffle_bytes: int = 0
    device_repartitions: int = 0     # shuffles routed through the kernels
    match_overhead_s: float = 0.0    # plan-time Alg. 4 cost (0 on cache hits)
    stage_latency: Dict[str, float] = field(default_factory=dict)
    wall_s: float = 0.0
    shuffle_s: float = 0.0           # wall time spent inside real shuffles
    input_bytes: int = 0             # bytes scanned from the store
    output_bytes: int = 0            # bytes written back to the store
    planning_s: float = 0.0          # plan/compile wall for this run (0 on hit)
    plan_cache_hit: Optional[bool] = None   # None when run outside a Session
    candidate_measure_passes: int = 0       # measurement-pass executions
    # durable-tier I/O this run caused (DESIGN §10); zeros until the
    # durable tier is ported (the schema is the reference's)
    storage_io_bytes: int = 0
    storage_io_s: float = 0.0
    storage_rehydrations: int = 0
    # padded-layout accounting over the datasets this run scanned (DESIGN
    # §12): padded = bytes the layouts actually occupy, valid = bytes of
    # real rows.  The gap is what key skew costs; the Observer feeds it to
    # the cost model's padding term.
    padded_bytes: int = 0
    valid_bytes: int = 0
    # per-candidate runtime stats for this run (ExecutionRecord schema),
    # keyed by candidate signature; None unless the run is being observed
    # (run hooks attached) — the np.unique pass isn't free.
    candidate_stats: Optional[Dict[str, Dict[str, float]]] = None

    def modeled_network_s(self, bandwidth: float = 1.25e9) -> float:
        return self.shuffle_bytes / bandwidth


class Executor:
    """Executes PhysicalPlans over a :class:`~repro_torch.data.
    partition_store.PartitionStore`.  Stateless apart from the store
    binding (whose device the device shuffles run on): all run-to-run
    variation lives in the plan (structure) and the store (data)."""

    def __init__(self, store):
        self.store = store

    # ------------------------------------------------------------- execute --
    def execute(self, plan, *, hooks: Tuple[Callable, ...] = (),
                workload=None, planning_s: float = 0.0,
                cache_hit: Optional[bool] = None
                ) -> Tuple[Dict[int, Any], "EngineStats"]:
        """Run ``plan``; returns ``(node values, stats)``.

        ``hooks`` turn on the observation pass (per-candidate stats at
        partition nodes) and receive the finished stats.  ``workload``
        defaults to the plan's own workload (it is only user-visible
        through hooks).  ``planning_s`` /
        ``cache_hit`` carry the caller's planning cost into the stats so
        hooks observe them."""
        with _span("exec.run", "exec", workload=plan.workload_id,
                   cache_hit=cache_hit) as rsp:
            vals, stats = self._execute(
                plan, hooks=hooks, workload=workload, planning_s=planning_s,
                cache_hit=cache_hit)
            rsp.set(wall_ms=round(stats.wall_s * 1e3, 3),
                    shuffles=stats.shuffles_performed,
                    elided=stats.shuffles_elided)
            return vals, stats

    def _execute(self, plan, *, hooks, workload, planning_s,
                 cache_hit) -> Tuple[Dict[int, Any], "EngineStats"]:
        workload = workload if workload is not None else plan.workload
        g = plan.graph
        stats = EngineStats()
        if hooks:
            stats.candidate_stats = {}
        stats.planning_s = planning_s
        stats.plan_cache_hit = cache_hit
        # Alg. 4 ran at plan time; charge it to the run that compiled the plan
        stats.match_overhead_s = 0.0 if cache_hit else plan.match_overhead_s
        # Resolve every scanned dataset BEFORE any step runs (one snapshot,
        # DESIGN §11): a stale plan fails fast with no side effects, so
        # plan_and_execute can re-plan and retry safely even for workloads
        # that write — and once execution starts, the run holds its
        # StoredDataset objects directly, so a concurrent generation flip
        # (or the pinned generation leaving the retention window mid-run)
        # cannot touch an in-flight execution.
        scans: Dict[int, Any] = {}
        for step in plan.steps:
            if step.kind != "scan":
                continue
            if plan.pinned:
                ds = self.store.read(step.dataset)
                if ds.generation != step.generation:
                    # the current pointer moved past the pin; the retained
                    # pinned generation may still resolve — prefer failing
                    # fast so the caller re-plans against the fresh layout
                    raise StalePlanError(
                        f"plan for {plan.workload_id!r} was compiled against "
                        f"{step.dataset}@gen{step.generation} but the store "
                        f"now holds gen{ds.generation}; re-plan (Session.run "
                        "re-keys the plan cache automatically)")
                scans[step.nid] = ds
            else:
                scans[step.nid] = self.store.read(step.dataset)
        t_start = time.perf_counter()
        vals: Dict[int, Any] = {}

        for step in plan.steps:
            node = g.nodes[step.nid]
            t0 = time.perf_counter()
            kind = step.kind
            parents = g.parents(step.nid)

            with _span("exec." + kind, "exec", nid=step.nid,
                       label=node.label) as ssp:
                if kind == "scan":
                    # the generation resolved by the up-front snapshot
                    # (pinned plans: exactly the layout the elisions were
                    # planned for), held as an object — immune to
                    # concurrent pointer flips
                    ds = scans[step.nid]
                    flat = ds.gather()
                    dev = device_flat_columns(ds) if step.device_relay \
                        else None
                    stats.input_bytes += ds.nbytes
                    stats.padded_bytes += int(ds.padded_bytes)
                    stats.valid_bytes += int(ds.valid_bytes)
                    ssp.set(dataset=step.dataset, generation=ds.generation,
                            rows=ds.num_rows)
                    vals[step.nid] = TableVal(flat, ds.counts.copy(),
                                              ds.partitioner,
                                              device_columns=dev)
                elif kind == "partition":
                    ssp.set(elide=step.elide,
                            path=("elide" if step.elide else
                                  "device" if step.device_op else "host"))
                    vals[step.nid] = self._exec_partition(step, g, vals,
                                                          stats)
                elif kind == "join":
                    vals[step.nid] = self._exec_join(
                        vals[parents[0]], vals[parents[1]], step.projection)
                elif kind == "aggregate":
                    vals[step.nid] = self._exec_aggregate(vals[parents[0]],
                                                          node.params)
                elif kind == "apply":
                    vals[step.nid] = self._exec_map(vals[parents[0]],
                                                    node.params["fn"])
                elif kind == "flatten":
                    vals[step.nid] = self._exec_flatten(vals[parents[0]])
                elif kind == "filter":
                    vals[step.nid] = self._exec_filter(vals[parents[0]],
                                                       vals[parents[1]])
                elif kind == "write":
                    tv: TableVal = vals[parents[0]]
                    cols = {k: v for k, v in tv.columns.items()
                            if k != "__key__"}
                    self.store.write_layout(step.dataset, cols,
                                            tv.counts, tv.partitioner,
                                            device_columns=tv.device_columns)
                    stats.output_bytes += int(sum(v.nbytes
                                                  for v in cols.values()))
                    ssp.set(dataset=step.dataset)
                    vals[step.nid] = tv
                else:
                    # lambda nodes: evaluate over parent values
                    # (columns/TableVal)
                    fn = resolve_fn(node.label, node.params)
                    args = [vals[p].columns if isinstance(vals[p], TableVal)
                            else vals[p] for p in parents]
                    vals[step.nid] = fn(*args)
            stats.stage_latency[f"{step.nid}:{node.label}"] = \
                stats.stage_latency.get(f"{step.nid}:{node.label}", 0.0) + \
                (time.perf_counter() - t0)

        stats.wall_s = time.perf_counter() - t_start
        for hook in hooks:
            hook(workload, stats)
        return vals, stats

    # ------------------------------------------------------- partition step --
    def _exec_partition(self, step, g, vals, stats) -> TableVal:
        """Execute one bound partition step.

        The elide-vs-shuffle decision was frozen at plan time (Alg. 4 run
        statically against the pinned store layout); only the key
        evaluation, the measurement pass (when observed) and the actual
        data movement happen here."""
        table: TableVal = _first_table(vals, g, step.nid)
        key_vals = to_numpy(vals[step.key_node]).reshape(-1)

        # observation (DESIGN §8): per-candidate runtime stats measured at
        # this node feed the run hooks.  Gated: without a run hook the
        # np.unique pass is skipped entirely.
        if stats.candidate_stats is not None and step.candidate is not None:
            stats.candidate_measure_passes += 1
            _record_candidate_stats(stats.candidate_stats,
                                    step.candidate.signature(), table,
                                    key_vals)

        if step.elide:
            stats.shuffles_elided += 1
            out = TableVal(dict(table.columns), table.counts.copy(),
                           table.partitioner,
                           device_columns=table.device_columns)
            out.columns["__key__"] = key_vals
            return out                       # layout already correct

        # shuffle: hash the key column, re-bucket every column
        t_sh = time.perf_counter()
        if step.device_op and key_vals.size:
            # DESIGN §5: one cached plan — hash kernel + histogram +
            # counting-sort kernel + packed gather; upstream device flats
            # (scan of a device store) feed it without re-upload.  Its
            # copy to the host synchronizes, so shuffle_s covers the
            # device work.
            res = device_rebucket_full(table.columns, key_vals, table.m,
                                       device=self.store.device,
                                       device_columns=table.device_columns)
            stats.shuffles_performed += 1
            stats.device_repartitions += 1
            stats.shuffle_bytes += int(table.nbytes() * (table.m - 1)
                                       / table.m)
            stats.shuffle_s += time.perf_counter() - t_sh
            return TableVal(res.columns, res.counts,
                            step.candidate or table.partitioner,
                            device_columns=res.device_columns)
        if step.strategy == "range":
            lo, hi = key_vals.min(), key_vals.max()
            width = max((hi - lo) / table.m, 1e-9)
            pids = np.clip(((key_vals - lo) / width).astype(np.int64),
                           0, table.m - 1)
        else:
            pids = to_numpy(_mix_hash(key_vals)).astype(np.int64) % table.m
        order = np.argsort(pids, kind="stable")
        counts = np.bincount(pids, minlength=table.m).astype(np.int64)
        new_cols = {k: v[order] for k, v in table.columns.items()}
        new_cols["__key__"] = key_vals[order]
        stats.shuffles_performed += 1
        stats.shuffle_bytes += int(table.nbytes() * (table.m - 1) / table.m)
        stats.shuffle_s += time.perf_counter() - t_sh
        return TableVal(new_cols, counts, step.candidate or table.partitioner)

    # ------------------------------------------------------------- join node --
    def _exec_join(self, left: TableVal, right: TableVal,
                   projection: Optional[Callable]) -> TableVal:
        out_segments: List[Columns] = []
        counts = np.zeros(left.m, np.int64)
        for w in range(left.m):
            lc, rc = left.worker_slice(w), right.worker_slice(w)
            lk = lc.pop("__key__")
            rk = rc.pop("__key__")
            if lk.size == 0 or rk.size == 0:
                continue
            sidx = np.argsort(rk, kind="stable")
            rk_sorted = rk[sidx]
            pos = np.searchsorted(rk_sorted, lk)
            pos = np.clip(pos, 0, rk_sorted.size - 1)
            hit = rk_sorted[pos] == lk
            ridx = sidx[pos[hit]]
            lsel = np.nonzero(hit)[0]
            seg: Columns = {k: v[lsel] for k, v in lc.items()}
            for k, v in rc.items():
                seg[f"r_{k}" if k in seg else k] = v[ridx]
            if projection is not None:
                seg = projection(seg)
            counts[w] = len(lsel)
            out_segments.append(seg)
        if out_segments:
            keys = out_segments[0].keys()
            cols = {k: np.concatenate([s[k] for s in out_segments])
                    for k in keys}
        else:
            cols = {}
        return TableVal(cols, counts, left.partitioner)

    # -------------------------------------------------------- aggregate node --
    def _exec_aggregate(self, table: TableVal, params) -> TableVal:
        reducer = params.get("reducer", "sum")
        fn = params.get("fn")
        if fn is not None:
            return TableVal(fn(table.columns), np.array([1] * table.m),
                            table.partitioner)
        # keyed aggregation: key is the repartition key from the upstream
        # partition node ("__key__"); values are all other columns
        out_segs: List[Columns] = []
        counts = np.zeros(table.m, np.int64)
        for w in range(table.m):
            seg = table.worker_slice(w)
            if not seg or len(next(iter(seg.values()))) == 0:
                continue
            key = seg.get("__key__", seg.get("key"))
            uk, inv = np.unique(key, return_inverse=True)
            agg: Columns = {"key": uk}
            for k, v in seg.items():
                if k in ("key", "__key__"):
                    continue
                acc = np.zeros((len(uk),) + v.shape[1:], np.float64)
                np.add.at(acc, inv, v)
                if reducer == "mean":
                    cnt = np.bincount(inv, minlength=len(uk)).astype(np.float64)
                    acc = acc / cnt.reshape((-1,) + (1,) * (acc.ndim - 1))
                agg[k] = acc.astype(v.dtype)
            counts[w] = len(uk)
            out_segs.append(agg)
        if out_segs:
            cols = {k: np.concatenate([s[k] for s in out_segs])
                    for k in out_segs[0]}
        else:
            cols = {}
        return TableVal(cols, counts, table.partitioner)

    # ------------------------------------------------------------- map/flatten --
    def _exec_map(self, table: TableVal, fn: Optional[Callable]) -> TableVal:
        if fn is None:
            return table
        return TableVal(fn(table.columns), table.counts.copy(),
                        table.partitioner)

    def _exec_flatten(self, table: TableVal) -> TableVal:
        fan = None
        cols: Columns = {}
        for k, v in table.columns.items():
            if v.ndim >= 2:
                fan = v.shape[1]
                cols[k] = v.reshape((-1,) + v.shape[2:])
        if fan is None:
            return table
        for k, v in table.columns.items():
            if v.ndim == 1:
                cols[k] = np.repeat(v, fan)
        return TableVal(cols, table.counts * fan, table.partitioner)

    def _exec_filter(self, table: TableVal, pred: np.ndarray) -> TableVal:
        pred = to_numpy(pred).reshape(-1).astype(bool)
        o = table.offsets()
        counts = np.array([int(pred[o[w]:o[w] + table.counts[w]].sum())
                           for w in range(table.m)], np.int64)
        cols = {k: v[pred] for k, v in table.columns.items()}
        return TableVal(cols, counts, table.partitioner)


def plan_and_execute(planner, executor: Executor, workload, backend, *,
                     hooks: Tuple[Callable, ...] = (),
                     max_replans: int = 4):
    """The run path behind ``Session.run``:
    plan (cached) + execute, transparently re-planning when a concurrent
    layout swap (e.g. a background Autopilot repartition) lands between
    the cache lookup and the executor's up-front generation check.

    Returns ``(vals, stats, plan)``.  The retry is side-effect-free:
    ``Executor.execute`` resolves and validates every scanned generation
    before running any step, so a stale plan (or a pin that left the
    bounded retention window under sustained background flips —
    ``RetiredGenerationError``) fails before any value is computed or
    written.  Together with the executor's one-snapshot read this makes a
    background Autopilot flip invisible to callers: they only ever see a
    complete result computed against one consistent layout (DESIGN §11).
    """
    for attempt in range(max_replans + 1):
        t0 = time.perf_counter()
        try:
            plan, hit = planner.physical(workload, backend)
            planning_s = time.perf_counter() - t0
            vals, stats = executor.execute(
                plan, hooks=hooks, workload=workload, planning_s=planning_s,
                cache_hit=hit)
            return vals, stats, plan
        except (StalePlanError, RetiredGenerationError):
            # the store moved under us; the next physical() re-keys
            # against the new generations and compiles a fresh plan
            if attempt == max_replans:
                raise


def _record_candidate_stats(out: Dict[str, Dict[str, float]], sig: str,
                            table: TableVal, key_vals: np.ndarray) -> None:
    """Measure the ExecutionRecord candidate-stat schema at a partition
    node.  Two partition nodes in one run can share a (structural)
    signature; merging mirrors features.py aggregation — max selectivity,
    min distinct keys — so per-run stats compose like per-group ones."""
    object_bytes = float(table.nbytes())
    key_bytes = float(key_vals.nbytes)
    # heavy-hitter sketch over the key column (DESIGN §12): a lower bound
    # on the hottest key's share, riding the same observation pass — the
    # Autopilot's salt trigger.  Merge-by-max below is correct for it.
    st = {
        "selectivity": key_bytes / object_bytes if object_bytes else 0.0,
        "distinct_keys": float(np.unique(key_vals).size),
        "num_objects": float(table.num_rows),
        "key_bytes": key_bytes,
        "object_bytes": object_bytes,
        "max_key_fraction": HeavyHitterSketch(k=8).update(key_vals)
        .max_fraction(),
    }
    cur = out.get(sig)
    if cur is None:
        out[sig] = st
        return
    for k, v in st.items():
        cur[k] = min(cur[k], v) if k == "distinct_keys" else max(cur[k], v)


def _first_table(vals, g, nid):
    for p in g.parents(nid):
        v = vals.get(p)
        if isinstance(v, TableVal):
            return v
        sub = _first_table(vals, g, p)
        if sub is not None:
            return sub
    return None
