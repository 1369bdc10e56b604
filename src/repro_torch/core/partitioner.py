"""Partitioner candidates: two-terminal DAG extraction (paper §3.1.2).

Alg. 1 (``search``) enumerates all simple paths from the dataset's scan node
to any partition node.  Alg. 2 (``merge``) merges paths sharing the same
(root, leaf) pair into one candidate subgraph.  A candidate is executable:
:meth:`PartitionerCandidate.key_fn` recompiles the subgraph into a key
projection — the paper's Listing 2 extracted from Listing 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ir import IRGraph, _canon, _mix_hash, to_numpy

HASH = "hash"
RANGE = "range"
ROUND_ROBIN = "roundrobin"
RANDOM = "random"
KEYED_STRATEGIES = (HASH, RANGE)
KEYLESS_STRATEGIES = (ROUND_ROBIN, RANDOM)


# ---------------------------------------------------------------------------
# Alg. 1: search(a_i, s_D) — all scan→partition simple paths
# ---------------------------------------------------------------------------

def search(graph: IRGraph, s_D: int) -> List[List[int]]:
    """Enumerate all simple paths that start at scan node ``s_D`` and end at
    the *first* partition node encountered (paper Alg. 1: recursion stops
    when v_k is a partition node)."""
    paths: List[List[int]] = []
    stack: List[Tuple[int, List[int]]] = [(s_D, [s_D])]
    while stack:
        node, path = stack.pop()
        for child in graph.children(node):
            if child in path:
                continue
            new_path = path + [child]
            if graph.nodes[child].is_partition:
                if len(new_path) > 1:
                    paths.append(new_path)
            else:
                stack.append((child, new_path))
    return paths


# ---------------------------------------------------------------------------
# Alg. 2: merge(F_i) — union paths by (root, leaf)
# ---------------------------------------------------------------------------

def merge(graph: IRGraph, paths: Sequence[Sequence[int]]) -> List["PartitionerCandidate"]:
    buckets: Dict[Tuple[int, int], Dict[str, set]] = {}
    for p in paths:
        key = (p[0], p[-1])
        b = buckets.setdefault(key, {"nodes": set(), "edges": set()})
        b["nodes"].update(p)
        b["edges"].update(zip(p[:-1], p[1:]))
    out: List[PartitionerCandidate] = []
    for (root, leaf), b in sorted(buckets.items()):
        sub = graph.subgraph(sorted(b["nodes"]))
        strategy = graph.nodes[leaf].params.get("strategy", HASH)
        out.append(PartitionerCandidate(
            graph=sub,
            strategy=strategy,
            source_dataset=graph.nodes[root].params.get("dataset", ""),
            origin=(root, leaf),
        ))
    return out


def enumerate_candidates(graph: IRGraph, dataset: str) -> List["PartitionerCandidate"]:
    """merge(search(h(w_i)), D) for one workload IR (paper §3.1.2)."""
    s_D = graph.find_scanner(dataset)
    if s_D is None:
        return []
    return merge(graph, search(graph, s_D))


# ---------------------------------------------------------------------------
# Candidates
# ---------------------------------------------------------------------------

@dataclass
class PartitionerCandidate:
    """A two-terminal subgraph + strategy; ``f_D`` in the paper."""

    graph: Optional[IRGraph]          # None for keyless strategies
    strategy: str = HASH
    source_dataset: str = ""
    origin: Tuple[int, int] = (-1, -1)  # (root, leaf) ids in the parent IR

    #: True when ``partition_ids`` is exactly hash(key) % m, so the device
    #: hash kernel may compute pids from the key column alone.  Subclasses
    #: with custom pid math (e.g. SaltedPartitioner) set this False and the
    #: store falls back to host pids + device scatter.
    kernel_dispatchable = True

    def __post_init__(self):
        if self.graph is not None and not self.graph.is_two_terminal():
            raise ValueError("partitioner candidate must be two-terminal")

    # -- identity -----------------------------------------------------------
    def signature_set(self) -> Tuple[str, ...]:
        """Sorted set of root→leaf path signatures (``ssset_D`` in Alg. 4)."""
        if self.graph is None:
            return (self.strategy,)
        (root,), (leaf,) = self.graph.roots(), self.graph.leaves()
        return tuple(self.graph.path_signatures(root, leaf))

    def signature(self) -> str:
        return "|".join(self.signature_set())

    @property
    def is_keyed(self) -> bool:
        return self.strategy in KEYED_STRATEGIES

    # -- executability --------------------------------------------------------
    def key_fn(self) -> Callable:
        if self.graph is None:
            raise ValueError(f"{self.strategy} partitioner has no key fn")
        return self.graph.compile_fn()

    def complexity(self) -> int:
        """Weight sum along the shortest root→leaf path (feature #4)."""
        if self.graph is None:
            return 0
        (root,), (leaf,) = self.graph.roots(), self.graph.leaves()
        paths = self.graph.all_paths(root, leaf)
        weights = {"parse": 5, "opaque": 3, "func": 2, "binop": 1, "attr": 1,
                   "literal": 0, "scan": 0, "partition": 0, "index": 1,
                   "cond": 1}
        def w(p):
            return sum(weights.get(self.graph.nodes[n].kind, 1) for n in p)
        return min(w(p) for p in paths)

    # -- application ------------------------------------------------------------
    def partition_ids(self, data: Any, num_partitions: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Map each object to a partition id — ``g(d_i)`` per §2.2.2.

        RANDOM draws from ``generator`` (default: seeded with 0).  Its bits
        differ from the reference's ``jax.random`` draw; what holds is that
        every row gets one pid in ``[0, m)``."""
        if self.strategy == HASH:
            key = self.key_fn()(data)
            return (_mix_hash(key) % num_partitions).to(torch.int32)
        if self.strategy == RANGE:
            # range(k): quantile binning against the observed key range, in
            # the reference's 32-bit arithmetic
            key = _canon(self.key_fn()(data))
            lo, hi = key.min(), key.max()
            width = torch.clamp_min((hi - lo) / num_partitions, 1e-9)
            return torch.clamp(((key - lo) / width).to(torch.int32),
                               0, num_partitions - 1)
        n = _num_objects(data)
        if self.strategy == ROUND_ROBIN:
            return (torch.arange(n) % num_partitions).to(torch.int32)
        if self.strategy == RANDOM:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            return torch.randint(0, num_partitions, (n,), dtype=torch.int32,
                                 generator=generator)
        raise ValueError(f"unknown strategy {self.strategy}")


@dataclass
class SaltedPartitioner(PartitionerCandidate):
    """Hot-key splitting (DESIGN §12): rows of a *hot* key are sprayed
    round-robin across ``salt_factor`` consecutive partitions instead of
    all landing on ``hash(key) % m``, so one heavy hitter stops dictating
    every partition's capacity.

    Correctness composes automatically: the salt is part of
    ``signature_set()``, so Alg. 4 never equates a salted layout with a
    consumer's plain hash partitioner — consumers shuffle (no wrong
    elision), and the Autopilot only applies salting when the padding
    savings outweigh the elision it forfeits (priced by the cost model).
    """

    hot_keys: Tuple = ()
    salt_factor: int = 4

    kernel_dispatchable = False     # pid math below ≠ plain hash(key) % m

    def signature_set(self) -> Tuple[str, ...]:
        base = super().signature_set()
        keys = ",".join(str(k) for k in self.hot_keys)
        return tuple(f"salt{self.salt_factor}[{keys}]({s})" for s in base)

    def partition_ids(self, data: Any, num_partitions: int,
                      generator: Optional[torch.Generator] = None) -> Any:
        keys = to_numpy(self.key_fn()(data)).reshape(-1)
        base = to_numpy(
            super().partition_ids(data, num_partitions)).astype(np.int64)
        hot = np.isin(keys, np.asarray(list(self.hot_keys),
                                       dtype=keys.dtype))
        salt = np.arange(keys.shape[0], dtype=np.int64) % self.salt_factor
        return np.where(hot, (base + salt) % num_partitions,
                        base).astype(np.int32)


def _num_objects(data: Any) -> int:
    if isinstance(data, dict):
        data = next(iter(data.values()))
    return int(data.shape[0]) if hasattr(data, "shape") else len(data)
