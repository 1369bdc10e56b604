"""Engine — the legacy eager entry point, now a deprecation shim.

Historically this module *was* the execution surface: ``Engine.run``
interpreted the traced IR node-by-node, re-extracting partitioner
candidates and re-running Alg. 4 on every run.  The planner/executor
split (DESIGN §9) moved that policy into
:class:`~repro_torch.core.planner.Planner` (Workload → LogicalPlan →
PhysicalPlan, cached by IR signature × store layout generation) and the
mechanics into :class:`~repro_torch.core.executor.Executor`; the public
facade is :class:`repro_torch.api.Session` (aka ``lachesis_torch.Session``).

``Engine`` remains as a thin shim so existing call sites keep working
bit-identically — it plans through the same cache and executes the same
steps — but every ``Engine.run`` emits a :class:`DeprecationWarning`.
Migration is mechanical::

    eng = Engine(store)                        # before
    vals, stats = eng.run(wl)

    sess = Session(store)                      # after
    res = sess.run(wl)                         # res.values, res.stats
    vals, stats = sess.run(wl)                 # tuple-unpacking still works

``TableVal`` and ``EngineStats`` are re-exported from
:mod:`repro_torch.core.executor`, their new home.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from .backends import UnknownBackendError, resolve_backend  # noqa: F401
from .executor import (EngineStats, Executor, StalePlanError,  # noqa: F401
                       TableVal, plan_and_execute)
from .planner import Planner

__all__ = ["Engine", "EngineStats", "TableVal", "StalePlanError",
           "UnknownBackendError"]


class Engine:
    """Deprecated facade over ``Planner`` + ``Executor``.

    Prefer :class:`repro_torch.api.Session`; this shim exists so
    pre-split call sites keep working.  ``backend`` defaults to
    ``"device"``, the port's default; its shuffles run on the store's
    device.
    """

    def __init__(self, store, enable_lachesis_matching: bool = True,
                 net_bandwidth: float = 1.25e9,
                 backend: str = "device",
                 history=None):
        self.backend = resolve_backend(backend).name   # UnknownBackendError
        self.net_bandwidth = net_bandwidth
        # observation hooks (DESIGN §8): `history` auto-logs an
        # ExecutionRecord per run; run_hooks fire with (workload, stats)
        # after every run (the service's Observer attaches here).
        self.history = history
        self.run_hooks: List[Callable[[Any, EngineStats], None]] = []
        # the same planning/execution stack Session uses
        self.planner = Planner(store, matching=enable_lachesis_matching)
        self.executor = Executor(store)

    # mutable knobs forward into the planner so the historical
    # `eng.matching = False` idiom keeps working
    @property
    def store(self):
        return self.planner.store

    @property
    def matching(self) -> bool:
        return self.planner.matching

    @matching.setter
    def matching(self, v: bool) -> None:
        self.planner.matching = bool(v)

    def add_run_hook(self, fn: Callable[[Any, EngineStats], None]) -> None:
        """Register ``fn(workload, stats)`` to fire after every run."""
        self.run_hooks.append(fn)

    # ------------------------------------------------------------------ run --
    def run(self, workload, backend: Optional[str] = None,
            history=None,
            timestamp: Optional[float] = None
            ) -> Tuple[Dict[int, Any], EngineStats]:
        """Deprecated: plan + execute in one call (use ``Session.run``).

        Semantics are unchanged from the eager interpreter: same values,
        same stats schema, history/hook observation identical — but the
        run now goes through the PhysicalPlan cache, so repeated runs of
        a frozen workload skip candidate extraction and Alg. 4 entirely.
        """
        warnings.warn(
            "Engine.run is deprecated; use lachesis_torch.Session "
            "(repro_torch.api.Session) — session.run(workload) returns the same "
            "(values, stats) and adds plan caching and explain()",
            DeprecationWarning, stacklevel=2)
        backend = self.backend if backend is None else \
            resolve_backend(backend).name
        history = self.history if history is None else history
        vals, stats, _plan = plan_and_execute(
            self.planner, self.executor, workload, backend,
            history=history, hooks=tuple(self.run_hooks),
            timestamp=timestamp)
        return vals, stats
