"""The paper's own workload suite as a selectable config (DESIGN §7).

Not an LM architecture: Lachesis's native "models" are UDF analytics
workflows.  This config bundles the canned DSL workloads (§5.1) with their
datasets so drivers/benchmarks can iterate over them uniformly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

from ..core import dsl


@dataclass(frozen=True)
class PaperWorkloadConfig:
    name: str = "lachesis-paper-suite"
    workflows: Tuple[Tuple[str, Callable], ...] = (
        ("reddit_integration", dsl.author_integrator),
        ("pagerank_iteration", dsl.pagerank_iteration),
        ("block_matmul", dsl.matmul_workload),
        ("gram_matrix", lambda: dsl.matmul_workload(transpose_left=True)),
    )
    # paper §5.1 cluster points used for the modeled-network numbers
    clusters: Tuple[Tuple[str, int, float], ...] = (
        ("aws-5w-10gbps", 5, 1.25e9),
        ("aws-10w-10gbps", 10, 1.25e9),
        ("aws-10w-1gbps", 10, 0.125e9),
        ("gcp-8w-10gbps", 8, 1.25e9),
    )
    # Repartition backends benchmarked against each other (DESIGN §5):
    # "host" = numpy gather/re-bucket, "device" = the hash-partition CUDA
    # kernels + torch scatter (their plain torch versions on CPU tensors).
    engine_backends: Tuple[str, ...] = ("host", "device")


def get() -> PaperWorkloadConfig:
    return PaperWorkloadConfig()
