# Lachesis core, torch port.
#   ir, dsl          — analyzable/executable graph IR for UDF workloads
#   partitioner      — two-terminal candidate extraction (Alg. 1+2)
#   matching         — path-signature subgraph matching (Alg. 4)
#   history          — workflow analyzer + skeleton graph (§3.1.1)
#   features         — candidate state vector (§3.1.3)
#   advisor          — end-to-end partitioning_creation (Alg. 3)
#   backends         — capability-queried backend registry (DESIGN §9)
#   planner          — Workload → LogicalPlan → PhysicalPlan + plan cache
#   executor         — runs frozen PhysicalPlans (§4 semantics)
#   engine           — legacy eager facade, now a deprecation shim
#   sharding_bridge  — partitionings ⇄ placements on a device mesh
#   sharding_advisor — scores LM sharding variants with an injected roofline

from .ir import IRGraph, Node
from .dsl import Workload, author_integrator, pagerank_iteration, matmul_workload
from .partitioner import (PartitionerCandidate, SaltedPartitioner,
                          enumerate_candidates, keyless_candidates, search,
                          merge, dedupe, HASH, RANGE, ROUND_ROBIN, RANDOM)
from .matching import partitioning_match, plan_shuffles, MatchResult
from .history import HistoryStore, ExecutionRecord, SkeletonNode
from .features import candidate_features, build_state, state_dim
from .advisor import (partitioning_creation, apply_decision,
                      PartitioningDecision, GreedySelector, DRLSelector)
from .backends import (Backend, BackendRegistry, REGISTRY,
                       UnknownBackendError, resolve_backend, resolve_device)
from .planner import LogicalPlan, PhysicalPlan, PlanKey, PlanStep, Planner
from .executor import Executor, StalePlanError
from .engine import Engine, EngineStats, TableVal
