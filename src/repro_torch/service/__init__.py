# Autopilot: the online storage-optimizer service (DESIGN §8).
#   observer   — Session/Engine run hook → auto ExecutionRecords + calibration
#   cost_model — what-if layout scoring from measured shuffle throughput
#   optimizer  — the tick()/background decide→apply loop + Autopilot facade
#   drivers    — deterministic workload-drift scenarios (tests/bench/demo)
#   serving    — concurrent frontend: admission, coalescing, tenancy (§11)
#
# The torch port's copy: numpy, threads and the port's own store; the
# device work it causes (d2d repartitions, rebuckets, device shuffles)
# runs through the hash-partition kernels on the store's device.

from .observer import LogicalClock, Observer
from .cost_model import Calibration, LayoutScore, WhatIfCostModel
from .optimizer import (AppliedDecision, Autopilot, AutopilotConfig,
                        StorageOptimizer, TickReport)
from .drivers import (DriftScenarioReport, aggregate_result,
                      default_drift_config, drift_tables, q_orderkey,
                      q_partkey, run_drift_scenario)
from .serving import (AdmissionError, NamespacedWorkload, ServeTicket,
                      ServingFrontend, Tenant, TenantBudgetError, TENANT_SEP)
