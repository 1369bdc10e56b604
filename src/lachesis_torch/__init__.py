"""``lachesis_torch`` — the public API of the PyTorch/CUDA port.

A thin namespace over :mod:`repro_torch`, the counterpart of ``lachesis``:

    import lachesis_torch

    sess = lachesis_torch.Session(num_workers=8)    # CUDA, backend="device"
    sess.write("submissions", subs)
    res = sess.run(workload)
    print(sess.explain(workload))

Sessions run on the card unless the caller asks for the CPU
(``device="cpu"`` or ``backend="host"``).
"""

from repro_torch.api import RunResult, Session, StalePlanError, UnknownBackendError
from repro_torch.cluster import ClusterConfig, RebalanceAborted
from repro_torch.core.backends import (Backend, BackendRegistry, REGISTRY,
                                       backend_names, resolve_backend)
from repro_torch.core.dsl import Workload
from repro_torch.core.executor import EngineStats as RunStats
from repro_torch.core.planner import LogicalPlan, PhysicalPlan, Planner

__all__ = [
    "Session", "RunResult", "RunStats", "Workload",
    "LogicalPlan", "PhysicalPlan", "Planner",
    "Backend", "BackendRegistry", "REGISTRY", "backend_names",
    "resolve_backend", "UnknownBackendError", "StalePlanError",
    "ClusterConfig", "RebalanceAborted",
]


def autopilot(session, **kw):
    """Convenience: attach an online storage optimizer to ``session``."""
    return session.autopilot(**kw)
