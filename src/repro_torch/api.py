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
present and neither asked for, construction raises ``RuntimeError``.
"""

from __future__ import annotations

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

__all__ = ["Session", "RunResult", "UnknownBackendError", "StalePlanError"]

RunStats = EngineStats   # the stats schema, under its API-facing name


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP Queue 1: "
        f"{item})")


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
                 registry: Optional[BackendRegistry] = None,
                 plan_cache_capacity: int = 128,
                 store_path: Optional[str] = None,
                 memory_budget_bytes: Optional[int] = None,
                 adaptive_capacity: bool = False,
                 metrics: Optional["_obs_metrics.MetricsRegistry"] = None,
                 cluster=None):
        """``device`` is where a device-resident backend keeps its columns
        and runs its shuffles (default CUDA; ``"cpu"`` runs the kernels'
        plain versions).  ``adaptive_capacity`` (DESIGN §12) lets the store
        plan non-uniform per-partition capacities on skewed writes.
        ``store_path``, ``memory_budget_bytes`` and ``cluster`` belong to
        tiers not ported yet and raise ``NotImplementedError``."""
        if store_path is not None or memory_budget_bytes is not None:
            raise _not_ported("store_path=/memory_budget_bytes= (the durable "
                              "tier)", "data/storage/")
        if cluster is not None:
            raise _not_ported("cluster=", "cluster/")
        self.registry = registry or REGISTRY
        self._backend: Backend = self.registry.get(backend)
        if store is None:
            store = PartitionStore(num_workers=num_workers,
                                   backend=self._backend.name
                                   if self._backend.device_resident
                                   else "host",
                                   device=device,
                                   registry=self.registry,
                                   adaptive_capacity=adaptive_capacity)
        self.run_hooks: List[Callable[[Any, EngineStats], None]] = []
        self.metrics_registry = metrics or _obs_metrics.REGISTRY
        self.planner = Planner(store, registry=self.registry,
                               matching=matching,
                               cache_capacity=plan_cache_capacity,
                               metrics=self.metrics_registry)
        self.executor = Executor(store)
        self._current: Optional[Workload] = None
        self._wl_counter = 0
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
            backend: Optional[str] = None) -> RunResult:
        """Plan (or fetch the cached plan) and execute.

        Without ``workload``, runs the session's current implicit workload
        (built via the scan/join/... passthroughs) and clears it once the
        run succeeds — a failed run keeps it so it can be retried."""
        wl = self._resolve_wl(workload)
        with _obs_tracer.span("session.run", "session",
                              workload=getattr(wl, "app_id", "?")) as sp:
            vals, stats, plan = plan_and_execute(
                self.planner, self.executor, wl,
                self._resolve_backend(backend),
                hooks=tuple(self.run_hooks))
            sp.set(cache_hit=stats.plan_cache_hit,
                   wall_ms=round(stats.wall_s * 1e3, 3))
        if workload is None and wl is self._current:
            self._current = None
        return RunResult(values=vals, stats=stats, plan=plan, workload=wl)

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

    def repartition(self, name: str, partitioner, *, swap: bool = True):
        """Repartition a stored dataset (publishes a new generation; the
        affected cached plans miss on their next lookup)."""
        ds = self.store.read(name)
        return self.store.repartition(ds, partitioner, swap=swap)

    # -- observability ---------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Versioned JSON snapshot of every metric the session's registry
        holds (planner cache, store write totals, ShufflePlan cache)."""
        return self.metrics_registry.snapshot()

    def metrics_text(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        return self.metrics_registry.prometheus_text()

    # -- not ported yet --------------------------------------------------------
    def export_trace(self, path: Optional[str] = None):
        raise _not_ported("export_trace", "obs/export.py")

    def telemetry(self, limit: Optional[int] = None):
        raise _not_ported("telemetry", "obs/telemetry.py")

    def plan_rebalance(self, **kw):
        raise _not_ported("plan_rebalance", "cluster/")

    def rebalance(self, plan=None, **kw):
        raise _not_ported("rebalance", "cluster/")

    def autopilot(self, **kw):
        raise _not_ported("autopilot", "service/")

    def serve(self, **kw):
        raise _not_ported("serve", "service/")

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
