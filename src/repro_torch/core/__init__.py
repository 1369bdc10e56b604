# Lachesis core, torch port: the modules of the main path so far.
#   ir, dsl          — analyzable/executable graph IR for UDF workloads
#   partitioner      — two-terminal candidate extraction (Alg. 1+2)
#   matching         — path-signature subgraph matching (Alg. 4)
#   backends         — capability-queried backend registry (DESIGN §9)
#   planner          — Workload → LogicalPlan → PhysicalPlan + plan cache
#   executor         — runs frozen PhysicalPlans (§4 semantics)

from .ir import IRGraph, Node
from .dsl import Workload, author_integrator, pagerank_iteration, matmul_workload
from .partitioner import (PartitionerCandidate, SaltedPartitioner,
                          enumerate_candidates, search, merge,
                          HASH, RANGE, ROUND_ROBIN, RANDOM)
from .matching import partitioning_match, plan_shuffles, MatchResult
from .backends import (Backend, BackendRegistry, REGISTRY,
                       UnknownBackendError, resolve_backend, resolve_device)
from .planner import LogicalPlan, PhysicalPlan, PlanKey, PlanStep, Planner
from .executor import EngineStats, Executor, StalePlanError, TableVal
