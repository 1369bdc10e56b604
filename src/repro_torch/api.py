"""The stable public API: ``lachesis_torch.Session`` (DESIGN §9).

One facade over the whole pipeline::

    Workload DSL  →  LogicalPlan  →  PhysicalPlan  →  Executor
                      (normalize,      (bind backend      (run the
                       Alg. 1+2)        ops + Alg. 4       frozen steps)
                                        static elision,
                                        cached by layout
                                        generation)

    import lachesis_torch

    sess = lachesis_torch.Session(num_workers=8)     # CUDA, backend="device"
    sess.write("submissions", subs, cand)        # storage-time partitioning
    sess.write("authors", auths)
    res = sess.run(workload)
    print(sess.explain(workload))                # deterministic plan dump

The session runs on the card unless the caller asks for the CPU:
``device="cpu"`` keeps the device backend on CPU tensors (the kernels'
plain versions), ``backend="host"`` runs the numpy path.  With no card
present and neither asked for, construction raises ``RuntimeError`` — a
durable session (``store_path=``) too.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .core.backends import (Backend, BackendRegistry, REGISTRY,
                            UnknownBackendError)
from .core.dsl import Col, SetHandle, Workload
from .core.executor import (EngineStats, Executor, StalePlanError, TableVal,
                            plan_and_execute)
from .core.planner import LogicalPlan, PhysicalPlan, Planner
from .data.device_repartition import plan_cache_stats as _shuffle_plan_stats
from .data.partition_store import PartitionStore, StoredDataset
from .obs import metrics as _obs_metrics
from .obs import tracer as _obs_tracer
from .obs.export import to_chrome_trace, write_chrome_trace
from .obs.telemetry import RunProfile

__all__ = ["Session", "RunResult", "UnknownBackendError", "StalePlanError"]

RunStats = EngineStats   # the stats schema, under its API-facing name


@dataclass
class RunResult:
    """What ``Session.run`` returns: node values + stats + the plan that
    produced them.  Iterable as ``(values, stats)``."""
    values: Dict[int, Any]
    stats: EngineStats
    plan: PhysicalPlan
    workload: Workload

    def __iter__(self):
        return iter((self.values, self.stats))

    def value_of(self, handle) -> Any:
        """Value produced at a DSL handle (``Col``/``SetHandle``) or nid."""
        nid = handle._nid if isinstance(handle, Col) else int(handle)
        return self.values[nid]

    def table(self, handle) -> TableVal:
        v = self.value_of(handle)
        if not isinstance(v, TableVal):
            raise TypeError(f"node {handle} produced {type(v).__name__}, "
                            "not a set-valued table")
        return v


class Session:
    """The single entry point for storing, planning and running workloads.

    Owns one :class:`~repro_torch.data.partition_store.PartitionStore`,
    one :class:`~repro_torch.core.planner.Planner` (with its PhysicalPlan
    cache) and one :class:`~repro_torch.core.executor.Executor`."""

    def __init__(self, store: Optional[PartitionStore] = None, *,
                 num_workers: int = 8, backend: str = "device",
                 device="cuda", matching: bool = True,
                 history=None, registry: Optional[BackendRegistry] = None,
                 plan_cache_capacity: int = 128,
                 store_path: Optional[str] = None,
                 memory_budget_bytes: Optional[int] = None,
                 autoflush: bool = True,
                 adaptive_capacity: bool = False,
                 metrics: Optional["_obs_metrics.MetricsRegistry"] = None,
                 cluster=None):
        """``device`` is where a device-resident backend keeps its columns
        and runs its shuffles (default CUDA; ``"cpu"`` runs the kernels'
        plain versions).

        ``store_path`` (DESIGN §10) backs the session's store with the
        durable tier: an existing store directory — written by this
        package or the JAX package — is reattached (its layouts,
        partitioner signatures and generation numbers carry over, so this
        session's plans elide the shuffles a previous application's
        layouts paid for), a fresh directory is initialized.  Mutually
        exclusive with passing a ``store`` object.  ``memory_budget_bytes``
        spills the coldest datasets to their segments past the budget;
        ``autoflush=False`` defers persistence to :meth:`flush`.

        ``history`` (a :class:`~repro_torch.core.history.HistoryStore`)
        logs an ExecutionRecord per run, the input of the advisor (Alg. 3).
        ``adaptive_capacity`` (DESIGN §12) lets the store plan non-uniform
        per-partition capacities on skewed writes.

        ``cluster`` (DESIGN §14): a
        :class:`~repro_torch.cluster.ClusterConfig` shards the durable tier
        across directories-as-nodes behind a PartitionDirectory; requires
        ``store_path``.  Reattaching an existing cluster store needs no
        ``cluster`` argument — membership comes from the on-disk
        directory epoch.  A device session keeps the reassembled columns
        on its device."""
        self.registry = registry or REGISTRY
        self._backend: Backend = self.registry.get(backend)
        if store is not None and store_path is not None:
            raise ValueError("pass either store= or store_path=, not both")
        if store is None:
            store = PartitionStore(num_workers=num_workers,
                                   backend=self._backend.name
                                   if self._backend.device_resident
                                   else "host",
                                   device=device,
                                   registry=self.registry,
                                   root=store_path,
                                   memory_budget_bytes=memory_budget_bytes,
                                   autoflush=autoflush,
                                   adaptive_capacity=adaptive_capacity,
                                   cluster=cluster)
        elif cluster is not None:
            raise ValueError("cluster= applies to the session-built store; "
                             "pass a cluster store= object instead")
        self.history = history
        self.run_hooks: List[Callable[[Any, EngineStats], None]] = []
        self.metrics_registry = metrics or _obs_metrics.REGISTRY
        self.planner = Planner(store, registry=self.registry,
                               matching=matching,
                               cache_capacity=plan_cache_capacity,
                               metrics=self.metrics_registry)
        self.executor = Executor(store)
        self._autopilots: List[Any] = []
        self._current: Optional[Workload] = None
        self._wl_counter = 0
        # last-seen ShufflePlan build counter, for per-run rebuild deltas
        # in the telemetry RunProfile (lazy: first durable run initializes)
        self._traces_seen: Optional[int] = None
        _register_process_collectors(self.metrics_registry)
        store.register_metrics(self.metrics_registry)

    # -- backend / knobs -----------------------------------------------------
    @property
    def backend(self) -> str:
        return self._backend.name

    @property
    def device(self):
        return self.store.device

    @property
    def store(self):
        return self.planner.store

    # matching forwards into the planner: mutating it takes effect on the
    # next run (matching is part of the plan-cache key)
    @property
    def matching(self) -> bool:
        return self.planner.matching

    @matching.setter
    def matching(self, v: bool) -> None:
        self.planner.matching = bool(v)

    @property
    def num_workers(self) -> int:
        return self.store.m

    # -- workload building (DSL passthrough) --------------------------------
    def workload(self, app_id: Optional[str] = None) -> Workload:
        """Start (and make current) a fresh traced workload."""
        if app_id is None:
            self._wl_counter += 1
            app_id = f"session-wl-{self._wl_counter}"
        self._current = Workload(app_id)
        return self._current

    @property
    def current(self) -> Optional[Workload]:
        return self._current

    def scan(self, dataset: str) -> SetHandle:
        """Scan a stored dataset into the current workload (creating one
        implicitly if none is active)."""
        wl = self._current if self._current is not None else self.workload()
        return wl.scan(dataset)

    # Each passthrough operates on the workload that owns the handle, so
    # mixing handles from an explicit Workload also works.
    def partition(self, key: Col, strategy: str = "hash") -> SetHandle:
        return key._wl.partition(key, strategy)

    def join(self, left: SetHandle, right: SetHandle, **kw) -> SetHandle:
        return left._wl.join(left, right, **kw)

    def aggregate(self, x: SetHandle, **kw) -> SetHandle:
        return x._wl.aggregate(x, **kw)

    def filter(self, x: SetHandle, pred: Col) -> SetHandle:
        return x._wl.filter(x, pred)

    def map(self, x: SetHandle, fn: Callable, tag: str) -> SetHandle:
        return x._wl.map(x, fn, tag)

    def flatten(self, x: SetHandle) -> SetHandle:
        return x._wl.flatten(x)

    def write_result(self, x: SetHandle, dataset: str) -> SetHandle:
        """Terminal write of a workload branch (``Workload.write``).  Named
        distinctly from :meth:`write`, which stores host data directly."""
        return x._wl.write(x, dataset)

    # -- planning ------------------------------------------------------------
    def plan(self, workload: Optional[Workload] = None,
             backend: Optional[str] = None) -> PhysicalPlan:
        """Compiled (cached) PhysicalPlan for ``workload`` on the current
        store layout."""
        plan, _hit = self.planner.physical(self._resolve_wl(workload),
                                           self._resolve_backend(backend))
        return plan

    def logical_plan(self, workload: Optional[Workload] = None) -> LogicalPlan:
        return self.planner.logical(self._resolve_wl(workload))

    def explain(self, workload: Optional[Workload] = None,
                backend: Optional[str] = None) -> str:
        """Deterministic plan dump: per partition node the elide/shuffle
        decision (Alg. 4 applied statically), the bound backend op and the
        ShufflePlan bucket; plus the layout pins keying the plan cache."""
        return self.plan(workload, backend).explain()

    # -- execution -----------------------------------------------------------
    def run(self, workload: Optional[Workload] = None, *,
            backend: Optional[str] = None, history=None,
            timestamp: Optional[float] = None) -> RunResult:
        """Plan (or fetch the cached plan) and execute.

        Without ``workload``, runs the session's current implicit workload
        (built via the scan/join/... passthroughs) and clears it once the
        run succeeds — a failed run keeps it so it can be retried.
        ``history`` (default: the session's) logs the run's
        ExecutionRecord, stamped ``timestamp`` (default: now)."""
        wl = self._resolve_wl(workload)
        history = self.history if history is None else history
        with _obs_tracer.span("session.run", "session",
                              workload=getattr(wl, "app_id", "?")) as sp:
            vals, stats, plan = plan_and_execute(
                self.planner, self.executor, wl,
                self._resolve_backend(backend),
                history=history, hooks=tuple(self.run_hooks),
                timestamp=timestamp)
            sp.set(cache_hit=stats.plan_cache_hit,
                   wall_ms=round(stats.wall_s * 1e3, 3))
        if self.store.telemetry is not None:
            self._record_run_profile(wl, stats, plan)
        if workload is None and wl is self._current:
            self._current = None
        return RunResult(values=vals, stats=stats, plan=plan, workload=wl)

    def _record_run_profile(self, wl: Workload, stats: EngineStats,
                            plan: PhysicalPlan) -> None:
        """Append one RunProfile to the store's durable telemetry
        (DESIGN §15) — the (state, action, reward) record per run.
        ``retraces`` counts the ShufflePlans this run built."""
        traces = int(_shuffle_plan_stats().get("traces", 0))
        prev = self._traces_seen
        self._traces_seen = traces
        key = getattr(plan, "key", None)
        generations = {name: int(gen)
                       for name, gen, _sig in getattr(key, "layout", ())}
        profile = RunProfile(
            t=time.time(), workload=getattr(wl, "app_id", ""),
            process=_obs_tracer.TRACER.process,
            wall_s=float(stats.wall_s), shuffle_s=float(stats.shuffle_s),
            io_s=float(stats.storage_io_s),
            planning_s=float(stats.planning_s),
            plan_cache_hit=bool(stats.plan_cache_hit),
            retraces=traces - prev if prev is not None else 0,
            shuffles_performed=int(stats.shuffles_performed),
            shuffles_elided=int(stats.shuffles_elided),
            shuffle_bytes=int(stats.shuffle_bytes),
            input_bytes=int(stats.input_bytes),
            output_bytes=int(stats.output_bytes),
            io_bytes=int(stats.storage_io_bytes),
            padded_bytes=int(stats.padded_bytes),
            valid_bytes=int(stats.valid_bytes),
            placement_epoch=int(getattr(key, "placement_epoch", -1)),
            generations=generations)
        try:
            self.store.telemetry.record_run(profile)
        except OSError:          # telemetry is advisory — a full disk
            pass                 # must never fail the run that produced it

    def add_run_hook(self, fn: Callable[[Any, EngineStats], None]) -> None:
        """Register ``fn(workload, stats)`` to fire after every run."""
        self.run_hooks.append(fn)

    # -- plan cache ----------------------------------------------------------
    def plan_cache_stats(self) -> Dict[str, int]:
        """Planner cache counters merged with the ShufflePlan build
        counter: ``traces`` flat across repeated runs is the no-rebuild
        guarantee."""
        out = self.planner.cache_stats()
        out["traces"] = _shuffle_plan_stats()["traces"]
        return out

    def clear_plan_cache(self) -> None:
        self.planner.clear_cache()

    def invalidate(self, dataset: Optional[str] = None) -> int:
        """Eagerly drop cached plans scanning ``dataset`` (all if None)."""
        return self.planner.invalidate(dataset)

    # -- storage passthrough ---------------------------------------------------
    def write(self, name: str, data: Dict[str, Any], partitioner=None,
              seed: int = 0) -> StoredDataset:
        """Store host columns under ``name`` (storage-time partitioning)."""
        return self.store.write(name, data, partitioner, seed=seed)

    def read(self, name: str,
             generation: Optional[int] = None) -> StoredDataset:
        return self.store.read(name, generation=generation)

    def repartition(self, name: str, partitioner, *, mesh=None,
                    swap: bool = True):
        """Repartition a stored dataset (publishes a new generation; the
        affected cached plans miss on their next lookup).  ``mesh`` (a
        ``core.sharding_bridge.Mesh`` of any number of devices) places the
        result on it; a dataset already placed on one is repartitioned
        shard to shard."""
        ds = self.store.read(name)
        return self.store.repartition(ds, partitioner, mesh=mesh, swap=swap)

    def flush(self, name: Optional[str] = None) -> int:
        """Persist pending generations to the durable tier (no-op without
        ``store_path``).  Returns the number of generations published."""
        return self.store.flush(name)

    @property
    def store_path(self) -> Optional[str]:
        return self.store.root if self.store.is_durable else None

    # -- cluster passthrough (DESIGN §14) ------------------------------------
    @property
    def directory(self):
        """The store's PartitionDirectory (None off-cluster)."""
        return self.store.directory

    def plan_rebalance(self, **kw):
        """Plan an incremental placement change without applying it."""
        return self.store.plan_rebalance(**kw)

    def rebalance(self, plan=None, **kw):
        """Apply (or plan-and-apply) a placement change; cached plans
        against the old placement epoch invalidate automatically."""
        return self.store.rebalance(plan=plan, **kw)

    # -- observability ---------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Versioned JSON snapshot of every metric the session's registry
        holds (planner cache, store write totals, ShufflePlan cache)."""
        return self.metrics_registry.snapshot()

    def metrics_text(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        return self.metrics_registry.prometheus_text()

    def export_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Export the tracer's finished spans as Chrome ``trace_event``
        JSON (open in Perfetto / ``chrome://tracing``).  Writes to
        ``path`` when given; always returns the document.  Requires
        tracing on: ``repro_torch.obs.enable()``."""
        meta = {"session_backend": self.backend,
                "num_workers": self.num_workers}
        if path is not None:
            return write_chrome_trace(path, metadata=meta)
        return to_chrome_trace(metadata=meta)

    def telemetry(self, limit: Optional[int] = None) -> List[RunProfile]:
        """Per-run :class:`RunProfile` records from the store's durable
        telemetry history (DESIGN §15), oldest first — these survive
        process restarts because they live under the store root.  Empty
        without ``store_path``."""
        tele = self.store.telemetry
        if tele is None:
            return []
        return tele.run_profiles(limit=limit)

    @property
    def telemetry_store(self):
        """The underlying TelemetryStore (None without ``store_path``)."""
        return self.store.telemetry

    @property
    def watchdog(self):
        """The store's RegressionDetector (None without ``store_path``)."""
        return self.store.watchdog

    def export_node_metrics(self, node: Optional[str] = None) -> Optional[str]:
        """Snapshot this process's metrics registry to the store's
        ``telemetry/metrics-<node>.json`` (default node label: the
        tracer's process label) for the merged view.  Returns the path,
        or None without a durable store."""
        tele = self.store.telemetry
        if tele is None:
            return None
        return tele.write_node_metrics(self.metrics_registry,
                                       node or _obs_tracer.TRACER.process)

    def cluster_metrics(self) -> Dict[str, Any]:
        """Merged metrics snapshot over every node's exported
        ``metrics-*.json`` — one document, ``node`` label per sample
        (empty without a durable store)."""
        tele = self.store.telemetry
        if tele is None:
            return {"version": _obs_metrics.METRICS_SCHEMA_VERSION,
                    "nodes": [], "metrics": {}}
        return tele.cluster_metrics()

    def cluster_metrics_text(self) -> str:
        """The merged cluster view as Prometheus text exposition."""
        return _obs_metrics.snapshot_prometheus_text(self.cluster_metrics())

    def explain_decisions(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Structured why-records for the Autopilot's recent decisions:
        every candidate's priced score and which gate (hysteresis,
        worth-it, skew threshold) accepted or rejected it.  Reads the
        in-memory records of attached autopilots first, then falls back
        to the durable ``decisions.log`` (kind=why rows, written by either
        package's Autopilot) so a fresh session on a durable store can
        still explain past decisions."""
        recs: List[Dict[str, Any]] = []
        for ap in self._autopilots:
            explain = getattr(ap, "explain", None)
            if explain is not None:
                recs.extend(explain())
        if not recs and self.store.is_durable:
            for row in self.store.durable.decisions():
                if row.get("kind") == "why":
                    # ticks batch their records into one JSONL row
                    recs.extend(row.get("records") or [])
        return recs[-limit:]

    # -- service attach --------------------------------------------------------
    def autopilot(self, **kw):
        """Attach an online storage optimizer (observer + cost model +
        decide/apply loop) to this session; returns the
        :class:`~repro_torch.service.Autopilot`.  Its applies run on the
        store's device (d2d repartitions, rebuckets)."""
        from .service import Autopilot
        ap = Autopilot(self, **kw)
        self._autopilots.append(ap)
        return ap

    def serve(self, **kw):
        """Open a concurrent serving frontend over this session's store
        (DESIGN §11): bounded admission, request coalescing, per-tenant
        namespaces/budgets.  Returns the
        :class:`~repro_torch.service.ServingFrontend`; composes with
        :meth:`autopilot` — background repartitions stay invisible to
        in-flight serves."""
        from .service import ServingFrontend
        return ServingFrontend(self, **kw)

    # -- internals ---------------------------------------------------------------
    def _resolve_wl(self, workload: Optional[Workload]) -> Workload:
        if workload is not None:
            return workload
        if self._current is None:
            raise ValueError("no workload: pass one to run()/plan() or "
                             "build the implicit one via session.scan(...)")
        return self._current

    def _resolve_backend(self, backend: Optional[str]) -> Backend:
        return self._backend if backend is None else self.registry.get(backend)


class _ProcessCollectors:
    """Anchor object for process-global metric callbacks (the ShufflePlan
    cache and the tracer's own health counters are process-wide, not
    per-session).  One anchor per registry, strongly held on the registry
    so the weakref callback stays alive."""

    def samples(self):
        for k, v in _shuffle_plan_stats().items():
            if isinstance(v, (int, float)):
                yield f"shuffleplan_cache_{k}", {}, v
        st = _obs_tracer.TRACER.stats()
        yield "tracer_spans_buffered", {}, st["buffered"]
        yield "tracer_spans_dropped_total", {}, st["dropped"]
        yield "trace_spans_dropped_total", {}, st["dropped"]
        mode_code = {"off": 0, "sampled": 1, "full": 2}.get(st["mode"], -1)
        yield "trace_mode", {"mode": st["mode"]}, mode_code


def _register_process_collectors(
        registry: "_obs_metrics.MetricsRegistry") -> None:
    if getattr(registry, "_process_collectors", None) is None:
        anchor = _ProcessCollectors()
        registry._process_collectors = anchor        # keeps weakref alive
        registry.register_callback(anchor, _ProcessCollectors.samples)
