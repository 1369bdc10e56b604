"""Planner — Workload DSL → LogicalPlan → PhysicalPlan (DESIGN §9).

The paper's thesis is that UDF workloads become optimizable once they are
*analyzable, reusable sub-computations*; this module is where that pays
off at execution time.  Planning happens in two stages:

``Planner.logical``
    Normalizes a traced :class:`~repro_torch.core.dsl.Workload` into a
    :class:`LogicalPlan`: topological node order, the partitioner
    candidates extracted per partition node (Alg. 1+2), the scanned
    datasets, and the memoized IR signature.

``Planner.compile``
    Binds a LogicalPlan against one :class:`~repro_torch.core.backends.Backend`
    and the *current* store layout into a frozen :class:`PhysicalPlan`:
    every partition node gets an elide-vs-shuffle decision (Alg. 4 run
    **statically at plan time** against the pinned layout generation), a
    concrete backend op (``device_rebucket[fused|hostperm]`` /
    ``host_argsort`` / ``host_range``) and — where the input cardinality
    is statically known — the ShufflePlan shape bucket the device path
    will dispatch through.

``Planner.physical`` caches PhysicalPlans in an LRU keyed by IR signature
× backend × worker count × per-dataset ``(generation, partitioner)``
layout pins, so re-running an unchanged workload on an unchanged store is
a pure cache hit (no candidate extraction, no Alg. 4, no plan rebuild),
while a layout-generation flip invalidates exactly the plans that scanned
the flipped dataset.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .backends import Backend, BackendRegistry, REGISTRY
from .ir import IRGraph, SET_OPS
from .matching import partitioning_match
from .partitioner import PartitionerCandidate, merge, search
from ..data.partition_store import RetiredGenerationError
from ..obs import metrics as _obs_metrics
from ..obs.tracer import span as _span

__all__ = ["LogicalPlan", "PhysicalPlan", "PlanKey", "PlanStep", "Planner"]


# ---------------------------------------------------------------------------
# Plan artifacts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanKey:
    """Identity of a PhysicalPlan: IR skeleton × node params × backend ×
    store layout.

    ``layout`` pins ``(dataset, generation, partitioner signature)`` for
    every dataset the workload scans — any repartition/rewrite bumps the
    generation and therefore misses the cache for exactly the plans that
    read that dataset.  ``param_signature`` covers what the structural IR
    signature deliberately drops (opaque fns, projections, reducers,
    scan/write dataset names): two structurally identical workloads with
    different UDFs or write targets must never share a plan, because a
    cached plan replays its own graph's params."""
    ir_signature: str
    param_signature: str
    backend: str
    num_workers: int
    matching: bool
    layout: Tuple[Tuple[str, int, str], ...]


_PRIMITIVES = (bool, int, float, str, bytes, type(None))


def param_signature(g: IRGraph) -> str:
    """Fingerprint of every node's params (O(nodes), cheap per run).

    Primitives fingerprint by value; callables and other objects by
    ``id`` — the cache is per-process, so identity is sound: a rebuilt
    lambda gets a fresh id and correctly misses, while reusing the same
    function object (or a param-free workload, like every canned one)
    keeps hitting across freshly traced workloads."""
    parts: List[str] = []
    for nid in sorted(g.nodes):
        for k in sorted(g.nodes[nid].params):
            v = g.nodes[nid].params[k]
            if v is None:
                continue
            if isinstance(v, _PRIMITIVES):
                parts.append(f"{nid}.{k}={v!r}")
            elif isinstance(v, tuple) and all(
                    isinstance(x, _PRIMITIVES) for x in v):
                parts.append(f"{nid}.{k}={v!r}")
            else:
                parts.append(f"{nid}.{k}=obj#{id(v)}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


@dataclass
class LogicalPlan:
    """Normalized IR + candidate annotations (backend-independent)."""
    workload: Any
    graph: IRGraph
    order: Tuple[int, ...]                       # toposorted node ids
    candidates: Dict[int, PartitionerCandidate]  # per partition node (Alg. 1+2)
    scan_datasets: Tuple[str, ...]               # sorted unique scanned names
    ir_signature: str

    @property
    def workload_id(self) -> str:
        return getattr(self.workload, "app_id", "<workload>")


@dataclass
class PlanStep:
    """One bound node of a PhysicalPlan.  ``kind`` selects the executor
    path; the optional fields carry the plan-time bindings for that kind."""
    nid: int
    kind: str
    label: str
    # scan
    dataset: str = ""
    generation: int = -1
    rows: int = -1
    device_relay: bool = False
    # partition
    key_node: int = -1
    strategy: str = ""
    candidate: Optional[PartitionerCandidate] = None
    elide: bool = False
    device_op: bool = False
    op: str = ""                     # bound backend op label (explain/debug)
    bucket: Optional[int] = None     # ShufflePlan shape bucket, if static
    # join
    projection: Optional[Callable] = None


@dataclass
class PhysicalPlan:
    """A frozen, executable artifact: the workload's nodes bound to
    concrete backend ops against one pinned store layout.

    Execute with :class:`~repro_torch.core.executor.Executor`; mutate nothing.
    Executing against a store whose generations moved past the pinned ones
    raises ``StalePlanError`` (``Session.run`` re-plans automatically)."""
    key: PlanKey
    workload: Any
    workload_id: str
    graph: IRGraph
    steps: Tuple[PlanStep, ...]
    backend: Backend
    elided: Tuple[int, ...]          # partition nids elided at plan time
    shuffled: Tuple[int, ...]        # partition nids bound to a real shuffle
    match_overhead_s: float = 0.0    # plan-time Alg. 4 wall
    pinned: bool = True              # executor enforces generation pins

    # ------------------------------------------------------------- explain --
    def explain(self) -> str:
        """Deterministic plan dump: per partition node the decision, bound
        backend op, and ShufflePlan bucket; plus the layout pins that key
        the cache.  Contains no timestamps, addresses or wall-clock."""
        lines = [f"PhysicalPlan {self.workload_id} "
                 f"backend={self.backend.name} workers={self.key.num_workers} "
                 f"matching={'on' if self.key.matching else 'off'}",
                 f"  ir: {self.key.ir_signature[:12]}"]
        layout = " ".join(
            f"{name}@gen{gen}[{sig or 'unpartitioned'}]"
            for name, gen, sig in self.key.layout) or "(no scans)"
        lines.append(f"  layout: {layout}")
        lines.append("  steps:")
        for s in self.steps:
            if s.kind == "scan":
                lines.append(f"    [{s.nid:3d}] scan {s.dataset} "
                             f"rows={s.rows} gen={s.generation}")
            elif s.kind == "partition":
                head = (f"    [{s.nid:3d}] partition[{s.strategy}] "
                        f"key<-n{s.key_node}")
                if s.dataset:
                    head += f" src={s.dataset}"
                if s.elide:
                    cand = s.candidate.signature() if s.candidate else "?"
                    lines.append(f"{head} ELIDED (Alg.4 static: layout "
                                 f"matches {cand})")
                else:
                    bucket = f"B{s.bucket}" if s.bucket else "dynamic"
                    lines.append(f"{head} op={s.op} bucket={bucket} shuffle")
            elif s.kind == "write":
                lines.append(f"    [{s.nid:3d}] write {s.dataset}")
            else:
                lines.append(f"    [{s.nid:3d}] {s.label}")
        lines.append(f"  shuffles: elided={len(self.elided)} "
                     f"performed={len(self.shuffled)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

class Planner:
    """Builds and caches PhysicalPlans for one store.

    ``cache_stats()`` exposes hit/miss/eviction counters; the companion
    ShufflePlan build counter lives in ``data.device_repartition.
    plan_cache_stats()`` (Session merges both)."""

    _ids = itertools.count(1)        # per-process planner instance label

    def __init__(self, store, *, registry: BackendRegistry = None,
                 matching: bool = True, cache_capacity: int = 128,
                 metrics: "_obs_metrics.MetricsRegistry" = None):
        if cache_capacity < 1:
            raise ValueError("plan cache capacity must be >= 1")
        self.store = store
        self.registry = registry or REGISTRY
        self.matching = matching
        self.cache_capacity = cache_capacity
        self._cache: "OrderedDict[PlanKey, PhysicalPlan]" = OrderedDict()
        # cache counters live in the MetricsRegistry (labeled per planner
        # instance so shared-registry sessions don't collide);
        # cache_stats() is a view over them — same keys/values as the old
        # private dict, now also exported via metrics()/prometheus_text()
        self.metrics = metrics or _obs_metrics.REGISTRY
        labels = {"planner": f"p{next(Planner._ids)}"}
        self._stats = {
            name: self.metrics.counter(
                f"planner_plan_cache_{name}_total",
                f"PhysicalPlan cache {name}", labels)
            for name in ("hits", "misses", "evictions", "invalidations")}
        self.metrics.register_callback(self, Planner._metric_samples)
        self._metric_labels = labels
        # guards _cache and _stats: the serving tier plans from many
        # threads against one shared planner (DESIGN §11).  Held only
        # around the OrderedDict/counter touches — compiles run outside
        # it, so concurrent different-key compiles proceed in parallel.
        self._lock = threading.RLock()

    def _metric_samples(self):
        yield ("planner_plan_cache_size", self._metric_labels,
               len(self._cache))

    # ------------------------------------------------------- logical stage --
    def logical(self, workload) -> LogicalPlan:
        """Workload DSL → normalized IR + candidate annotations."""
        g: IRGraph = workload.graph
        candidates: Dict[int, PartitionerCandidate] = {}
        for s in g.scans:
            for c in merge(g, search(g, s)):
                candidates[c.origin[1]] = c
        scans = tuple(sorted({g.nodes[s].params["dataset"]
                              for s in g.scans}))
        return LogicalPlan(workload=workload, graph=g,
                           order=tuple(g.toposort()), candidates=candidates,
                           scan_datasets=scans,
                           ir_signature=g.graph_signature())

    # ----------------------------------------------------------- cache key --
    def plan_key(self, workload, backend) -> PlanKey:
        """Cache identity for (workload, backend) against the live store."""
        backend = self.registry.get(backend)
        g: IRGraph = workload.graph
        layout = []
        for name in sorted({g.nodes[s].params["dataset"] for s in g.scans}):
            ds = self.store.datasets.get(name)
            if ds is None:
                layout.append((name, -1, ""))
            else:
                sig = ds.partitioner.signature() if ds.partitioner else ""
                layout.append((name, ds.generation, sig))
        return PlanKey(ir_signature=g.graph_signature(),
                       param_signature=param_signature(g),
                       backend=backend.name,
                       num_workers=self.store.m, matching=self.matching,
                       layout=tuple(layout))

    # ---------------------------------------------------------- physical ----
    def physical(self, workload, backend) -> Tuple[PhysicalPlan, bool]:
        """Cached compile: returns ``(plan, cache_hit)``.

        The compile pins exactly the key's layout generations (not a
        second live read of the store), so a concurrent swap landing
        between key computation and compile can never cache a plan whose
        steps disagree with its key; if the pinned generation was retired
        in that window, re-key and retry."""
        for _ in range(4):
            with _span("planner.lookup", "planner") as lsp:
                key = self.plan_key(workload, backend)
                with self._lock:
                    plan = self._cache.get(key)
                    if plan is not None:
                        self._cache.move_to_end(key)
                        self._stats["hits"].inc()
                        lsp.set(hit=True, workload=plan.workload_id)
                        return plan, True
                lsp.set(hit=False)
            try:
                plan = self.compile(self.logical(workload),
                                    self.registry.get(backend), key=key)
            except RetiredGenerationError:
                continue      # pinned generation swapped out of retention
            with self._lock:
                # two threads may compile the same key concurrently (the
                # compile runs unlocked); last-in wins, both plans describe
                # the identical pinned layout so either is correct
                self._stats["misses"].inc()
                self._cache[key] = plan
                while len(self._cache) > self.cache_capacity:
                    self._cache.popitem(last=False)
                    self._stats["evictions"].inc()
            return plan, False
        raise RuntimeError(
            "store layout kept moving during planning (generations retired "
            "faster than they could be pinned); raise max_retired_generations")

    # ------------------------------------------------------- compile stage --
    def compile(self, logical: LogicalPlan, backend: Backend,
                key: Optional[PlanKey] = None) -> PhysicalPlan:
        """LogicalPlan × Backend × the key's pinned layout → PhysicalPlan.

        Datasets are resolved at the generations the key pins (retained by
        the store even across a concurrent swap), never re-read live — the
        cached plan always describes exactly its key.  Raises ``KeyError``
        if a pinned generation left the retention window (the caller
        re-keys)."""
        backend = self.registry.get(backend)
        if key is None:
            key = self.plan_key(logical.workload, backend)
        with _span("planner.compile", "planner",
                   workload=logical.workload_id,
                   backend=backend.name) as csp:
            plan = self._compile_pinned(logical, backend, key)
            csp.set(elided=len(plan.elided), shuffled=len(plan.shuffled))
            return plan

    def _compile_pinned(self, logical: LogicalPlan, backend: Backend,
                        key: PlanKey) -> PhysicalPlan:
        pinned = {name: (self.store.read(name, generation=gen)
                         if gen >= 0 else None)
                  for name, gen, _sig in key.layout}
        g = logical.graph
        steps: List[PlanStep] = []
        elided: List[int] = []
        shuffled: List[int] = []
        match_s = 0.0
        for nid in logical.order:
            node = g.nodes[nid]
            kind = node.kind
            step = PlanStep(nid=nid, kind=kind, label=node.label)
            if kind == "scan":
                step.dataset = node.params["dataset"]
                ds = pinned.get(step.dataset)
                if ds is not None:
                    step.generation = ds.generation
                    step.rows = ds.num_rows
                step.device_relay = backend.device_relay
            elif kind == "partition":
                step.key_node = g.parents(nid)[0]
                step.strategy = node.params.get("strategy", "hash")
                cand = logical.candidates.get(nid)
                step.candidate = cand
                if cand is not None:
                    step.dataset = g.nodes[cand.origin[0]].params.get(
                        "dataset", "")
                # Alg. 4, statically: does the pinned layout of the scanned
                # dataset already realize this node's partitioner?
                stored = pinned.get(step.dataset) if step.dataset else None
                if (cand is not None and self.matching and stored is not None
                        and stored.partitioner is not None):
                    t0 = time.perf_counter()
                    m = partitioning_match(stored.partitioner, step.dataset, g)
                    match_s += time.perf_counter() - t0
                    step.elide = nid in m.partition_nodes
                if step.elide:
                    step.op = "elide"
                    elided.append(nid)
                else:
                    step.device_op = (backend.kernel_shuffle
                                      and step.strategy == "hash")
                    step.op = backend.partition_op(step.strategy,
                                                   self.store.device)
                    rows = self._static_rows(cand, stored)
                    if step.device_op and rows is not None:
                        from ..data.device_repartition import shape_bucket
                        step.bucket = shape_bucket(rows)
                    shuffled.append(nid)
            elif kind == "join":
                step.projection = node.params.get("projection")
            elif kind == "write":
                step.dataset = node.params["dataset"]
            steps.append(step)
        return PhysicalPlan(key=key, workload=logical.workload,
                            workload_id=logical.workload_id, graph=g,
                            steps=tuple(steps), backend=backend,
                            elided=tuple(elided), shuffled=tuple(shuffled),
                            match_overhead_s=match_s)

    @staticmethod
    def _static_rows(cand: Optional[PartitionerCandidate],
                     stored) -> Optional[int]:
        """Input cardinality of a partition node, when statically known:
        a first-level candidate whose scan→partition chain contains no
        row-changing set op flows exactly the stored dataset's rows."""
        if cand is None or cand.graph is None or stored is None:
            return None
        for n in cand.graph.nodes.values():
            if n.kind in SET_OPS and n.kind not in ("scan", "partition"):
                return None
        return int(stored.num_rows)

    # --------------------------------------------------------- maintenance --
    def cache_stats(self) -> Dict[str, int]:
        with self._lock:
            return {**{k: int(c.value) for k, c in self._stats.items()},
                    "size": len(self._cache)}

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()

    def invalidate(self, dataset: Optional[str] = None) -> int:
        """Drop cached plans that scan ``dataset`` (all plans if None).
        Generation-keyed lookups already miss stale plans; this frees them
        eagerly (e.g. after a dataset is dropped)."""
        with self._lock:
            if dataset is None:
                n = len(self._cache)
                self._cache.clear()
            else:
                doomed = [k for k in self._cache
                          if any(name == dataset for name, _, _ in k.layout)]
                for k in doomed:
                    del self._cache[k]
                n = len(doomed)
            if n:
                self._stats["invalidations"].inc(n)
            return n
