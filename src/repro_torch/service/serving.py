"""Serving tier — one shared store, many live sessions (DESIGN §11).

The paper's claim is that Lachesis optimizes storage *across
applications*; this module is the execution surface where many
applications actually coexist.  A :class:`ServingFrontend` admits
concurrent workloads against one shared
:class:`~repro_torch.data.partition_store.PartitionStore` through the same
Planner/Executor stack a single :class:`~repro_torch.api.Session` uses — the
whole point of the thread-safety work in the store (lock-free
generation-pointer reads), the planner (locked PhysicalPlan cache) and
the executor (one up-front scan snapshot per run):

* **Admission + backpressure** — a bounded thread pool with a bounded
  wait queue.  A full queue rejects (:class:`AdmissionError`) or blocks,
  caller's choice, so overload degrades service latency instead of
  memory.
* **Request coalescing** — identical *read-only* requests (same plan-
  cache key, i.e. same IR × params × backend × layout generations) share
  one execution: a plan-cache hit already costs ~12–30 µs, so the only
  thing worth deduplicating is the execution itself.  A generation flip
  changes the key, so coalescing never crosses layouts.
* **Tenancy** — tenants own disjoint dataset-name prefixes inside the
  shared store, each with an optional byte budget
  (:class:`TenantBudgetError` on the offender only) and fault isolation:
  one tenant's failing UDF fails that tenant's ticket, nothing else.
* **MVCC under the Autopilot** — a background repartition publishes a new
  generation with one atomic pointer flip; in-flight runs hold the
  StoredDataset objects of the generation they resolved, and queued runs
  transparently re-plan on ``StalePlanError``/``RetiredGenerationError``.
  Live readers never stall and never observe a half-shuffled table.

Usage::

    sess = lachesis.Session(num_workers=8)
    front = sess.serve(max_workers=8, max_queue=64)
    alice = front.tenant("alice", memory_budget_bytes=1 << 30)
    alice.write("events", events_cols, cand)
    wl = alice.workload(); wl.write(wl.aggregate(...), "daily")
    ticket = front.submit(wl)           # -> ServeTicket (a future)
    result = ticket.result(timeout=30)  # RunResult, same as Session.run
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.dsl import SetHandle, Workload
from ..obs.tracer import TRACER as _TRACER, span as _span

__all__ = ["ServingFrontend", "ServeTicket", "Tenant", "NamespacedWorkload",
           "AdmissionError", "TenantBudgetError", "TENANT_SEP"]

#: separates the tenant namespace from the dataset name inside the store
TENANT_SEP = "::"


class AdmissionError(RuntimeError):
    """The frontend's bounded queue is full — backpressure.  Retry later,
    or submit with ``block=True`` to wait for a slot."""


class TenantBudgetError(RuntimeError):
    """A tenant write would exceed that tenant's byte budget.  Only the
    offending tenant sees this; other tenants' traffic is unaffected."""


class NamespacedWorkload(Workload):
    """A Workload whose ``scan``/``write`` dataset names are transparently
    qualified with a tenant prefix — tenant code reads and writes short
    names while the shared store keys everything by namespace."""

    def __init__(self, app_id: str, prefix: str):
        super().__init__(app_id)
        self.prefix = prefix

    def _qualify(self, dataset: str) -> str:
        if dataset.startswith(self.prefix):
            return dataset
        return self.prefix + dataset

    def scan(self, dataset: str) -> SetHandle:
        return super().scan(self._qualify(dataset))

    def write(self, x: SetHandle, dataset: str) -> SetHandle:
        return super().write(x, self._qualify(dataset))


class ServeTicket:
    """Admission receipt for one submitted workload — a future.

    ``result()`` blocks until the run completes and returns the same
    :class:`~repro_torch.api.RunResult` a synchronous ``Session.run`` would
    have; a failed run re-raises the worker's exception here (and only
    here — failures are per-ticket).  Coalesced submissions share one
    ticket: every caller of ``result()`` sees the single execution."""

    def __init__(self, key: Optional[Tuple] = None):
        self.key = key
        self.submitted_at = time.perf_counter()
        self.finished_at: Optional[float] = None
        self.coalesced_with = 0          # followers sharing this execution
        self._done = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        # tracing link back to the submitting thread's span (None when
        # tracing is off): the worker attaches it so the ticket's spans
        # parent across the pool handoff
        self._trace_ctx = _TRACER.context()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("serving ticket not finished "
                               f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finished_at is None \
            else self.finished_at - self.submitted_at

    # -- frontend internals --------------------------------------------------
    def _finish(self, result=None, error: Optional[BaseException] = None):
        self._result = result
        self._error = error
        self.finished_at = time.perf_counter()
        self._done.set()


class Tenant:
    """One tenant's view of the shared store: a dataset-name namespace, an
    optional byte budget, and submission sugar.  Obtained via
    :meth:`ServingFrontend.tenant`."""

    def __init__(self, frontend: "ServingFrontend", name: str,
                 memory_budget_bytes: Optional[int] = None):
        if TENANT_SEP in name:
            raise ValueError(f"tenant name may not contain {TENANT_SEP!r}")
        self.frontend = frontend
        self.name = name
        self.memory_budget_bytes = memory_budget_bytes
        self._wl_counter = 0

    @property
    def prefix(self) -> str:
        return self.name + TENANT_SEP

    def qualify(self, dataset: str) -> str:
        return dataset if dataset.startswith(self.prefix) \
            else self.prefix + dataset

    def used_bytes(self) -> int:
        """Logical bytes of this tenant's current-generation datasets."""
        return self.frontend.store.namespace_bytes(self.prefix)

    def workload(self, app_id: Optional[str] = None) -> NamespacedWorkload:
        if app_id is None:
            self._wl_counter += 1
            app_id = f"{self.name}-wl-{self._wl_counter}"
        return NamespacedWorkload(app_id, self.prefix)

    def write(self, name: str, data: Dict[str, Any], partitioner=None,
              seed: int = 0):
        """Store host columns under this tenant's namespace, enforcing the
        tenant budget BEFORE any bytes land — an over-budget write raises
        :class:`TenantBudgetError` and changes nothing."""
        incoming = int(sum(np.asarray(v).nbytes for v in data.values()))
        if self.memory_budget_bytes is not None:
            used = self.used_bytes()
            if used + incoming > self.memory_budget_bytes:
                raise TenantBudgetError(
                    f"tenant {self.name!r}: write of {incoming} B would "
                    f"exceed budget ({used} used of "
                    f"{self.memory_budget_bytes} B)")
        return self.frontend.store.write(self.qualify(name), data,
                                         partitioner, seed=seed)

    def read(self, name: str, generation: Optional[int] = None):
        return self.frontend.store.read(self.qualify(name),
                                        generation=generation)

    def submit(self, workload: Workload, **kw) -> ServeTicket:
        return self.frontend.submit(workload, tenant=self.name, **kw)

    def run(self, workload: Workload, *, timeout: Optional[float] = None,
            **kw):
        return self.submit(workload, **kw).result(timeout)


@dataclass
class _Counters:
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    coalesced: int = 0
    completed: int = 0
    failed: int = 0
    latencies_s: List[float] = field(default_factory=list)


class ServingFrontend:
    """Admits many concurrent workloads against one shared store.

    Wraps an existing :class:`~repro_torch.api.Session` (idiomatically via
    ``session.serve()``) and shares its Planner — so the PhysicalPlan
    cache, and therefore the coalescing identity, is the same one the
    session uses — and its Executor, which is reentrant: all run state
    lives in the plan and the per-run value table.

    ``max_workers`` bounds concurrent executions; ``max_queue`` bounds
    *waiting* admissions beyond that — the backpressure surface.
    ``observe=True`` routes every serve through the session's run hooks
    and history, feeding an attached Autopilot exactly as synchronous
    runs do.

    Every worker launches its device work on the device's current stream,
    the one stream all threads share, so a tensor produced in one thread
    and read in another needs no cross-stream sync.  A side stream would
    need ``record_stream`` on every tensor that crosses threads."""

    def __init__(self, session, *, max_workers: int = 8,
                 max_queue: int = 64, coalesce: bool = True,
                 observe: bool = True):
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self.session = session
        self.planner = session.planner
        self.executor = session.executor
        self.max_workers = max_workers
        self.max_queue = max_queue
        self.coalesce_default = coalesce
        self.observe = observe
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="lachesis-serve")
        self._slots = threading.BoundedSemaphore(max_workers + max_queue)
        self._inflight: Dict[Tuple, ServeTicket] = {}
        self._inflight_lock = threading.Lock()
        self._counters = _Counters()
        self._counters_lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {}
        self._closed = False
        # metrics (DESIGN §13): counters stay in _Counters (stats() is
        # the authoritative view); the registry gets them via a snapshot
        # callback plus a real latency histogram, labeled per frontend
        self._metric_labels = {"frontend":
                               f"f{next(ServingFrontend._ids)}"}
        reg = getattr(session, "metrics_registry", None)
        self._latency_hist = None
        if reg is not None:
            self._latency_hist = reg.histogram(
                "serving_latency_seconds", "serve ticket latency",
                self._metric_labels)
            reg.register_callback(self, ServingFrontend._metric_samples)

    _ids = itertools.count(1)

    def _metric_samples(self):
        for k, v in self.stats().items():
            yield f"serving_{k}", self._metric_labels, float(v)

    def metrics(self) -> Dict[str, Any]:
        """Versioned JSON snapshot of the session registry this frontend
        reports into (serving counters + latency histogram included)."""
        return self.session.metrics_registry.snapshot()

    def metrics_text(self) -> str:
        return self.session.metrics_registry.prometheus_text()

    @property
    def store(self):
        return self.session.store

    # -- tenancy -------------------------------------------------------------
    def tenant(self, name: str,
               memory_budget_bytes: Optional[int] = None) -> Tenant:
        """The named tenant's view (created on first use; a later call may
        tighten or lift its budget by passing ``memory_budget_bytes``)."""
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants.setdefault(
                name, Tenant(self, name, memory_budget_bytes))
        if memory_budget_bytes is not None:
            t.memory_budget_bytes = memory_budget_bytes
        return t

    # -- submission ----------------------------------------------------------
    def submit(self, workload: Workload, *, backend: Optional[str] = None,
               tenant: Optional[str] = None, coalesce: Optional[bool] = None,
               block: bool = False,
               timeout: Optional[float] = None) -> ServeTicket:
        """Admit ``workload``; returns a :class:`ServeTicket` immediately.

        Admission order: (1) an identical in-flight read-only request
        coalesces for free — no queue slot consumed; (2) otherwise a
        queue slot is acquired (``block=False`` raises
        :class:`AdmissionError` when the queue is full; ``block=True``
        waits up to ``timeout``) and the run is dispatched to the pool."""
        if self._closed:
            raise RuntimeError("frontend is closed")
        with self._counters_lock:
            self._counters.submitted += 1
        backend_name = (self.session.backend if backend is None else backend)

        with _span("serve.submit", "serve", tenant=tenant or "",
                   workload=getattr(workload, "app_id", "?")) as sub_sp:
            key: Optional[Tuple] = None
            if (self.coalesce_default if coalesce is None else coalesce) \
                    and self._read_only(workload):
                # the PhysicalPlan cache key IS the coalescing identity:
                # IR × params × backend × workers × layout generations.
                # Identical queued requests resolve the same key; a
                # concurrent generation flip changes it, so no
                # cross-layout sharing.
                key = (tenant, self.planner.plan_key(workload, backend_name))
                with self._inflight_lock:
                    leader = self._inflight.get(key)
                    if leader is not None and not leader.done():
                        leader.coalesced_with += 1
                        with self._counters_lock:
                            self._counters.coalesced += 1
                        sub_sp.set(outcome="coalesced")
                        return leader

            admitted = self._slots.acquire(timeout=timeout) if block \
                else self._slots.acquire(blocking=False)
            if not admitted:
                with self._counters_lock:
                    self._counters.rejected += 1
                sub_sp.set(outcome="rejected")
                raise AdmissionError(
                    f"serving queue full ({self.max_workers} workers + "
                    f"{self.max_queue} waiting); retry or submit(block=True)")
            ticket = ServeTicket(key=key)
            if key is not None:
                with self._inflight_lock:
                    self._inflight[key] = ticket
            with self._counters_lock:
                self._counters.admitted += 1
            sub_sp.set(outcome="admitted")
            self._pool.submit(self._run_ticket, ticket, workload,
                              backend_name)
            return ticket

    def run(self, workload: Workload, *, timeout: Optional[float] = None,
            **kw):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(workload, **kw).result(timeout)

    @staticmethod
    def _read_only(workload: Workload) -> bool:
        g = workload.graph
        return not any(n.kind == "write" for n in g.nodes.values())

    # -- the worker ----------------------------------------------------------
    def _run_ticket(self, ticket: ServeTicket, workload: Workload,
                    backend: str) -> None:
        from ..api import RunResult
        from ..core.executor import plan_and_execute
        try:
            # adopt the submitting thread's span as parent (cross-pool
            # link; no-op when tracing is off or was off at submit time)
            with _TRACER.attach(ticket._trace_ctx), \
                    _span("serve.ticket", "serve",
                          workload=getattr(workload, "app_id", "?")) as tsp:
                hooks = tuple(self.session.run_hooks) if self.observe else ()
                history = self.session.history if self.observe else None
                vals, stats, plan = plan_and_execute(
                    self.planner, self.executor, workload, backend,
                    history=history, hooks=hooks)
                # a last step that writes to a device store leaves its
                # scatter queued: the ticket's latency waits for it
                self.store.synchronize()
                tsp.set(cache_hit=stats.plan_cache_hit,
                        coalesced_with=ticket.coalesced_with)
            ticket._finish(result=RunResult(values=vals, stats=stats,
                                            plan=plan, workload=workload))
            with self._counters_lock:
                self._counters.completed += 1
                self._counters.latencies_s.append(ticket.latency_s)
            if self._latency_hist is not None:
                self._latency_hist.observe(ticket.latency_s)
        except BaseException as e:       # noqa: BLE001 — per-ticket isolation
            ticket._finish(error=e)
            with self._counters_lock:
                self._counters.failed += 1
        finally:
            if ticket.key is not None:
                with self._inflight_lock:
                    if self._inflight.get(ticket.key) is ticket:
                        del self._inflight[ticket.key]
            self._slots.release()

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Counters + latency percentiles over completed serves."""
        with self._counters_lock:
            c = self._counters
            lat = np.asarray(c.latencies_s, np.float64)
            out: Dict[str, float] = {
                "submitted": c.submitted, "admitted": c.admitted,
                "rejected": c.rejected, "coalesced": c.coalesced,
                "completed": c.completed, "failed": c.failed,
                "inflight": len(self._inflight),
            }
        if lat.size:
            out["p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["p99_ms"] = float(np.percentile(lat, 99) * 1e3)
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self, wait: bool = True) -> None:
        self._closed = True
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "ServingFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
