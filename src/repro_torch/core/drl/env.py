"""Trace-driven training simulator (paper §4.3): a copy of the JAX
package's ``core/drl/env.py`` (numpy only), bit-equal to it.

The paper accelerates DRL training by replaying (state, action, reward)
traces derived from actual runs of a few TPC-H queries: per (partitioner
candidate, query) statistics + measured latencies for each of the 431
partition schemes.  Training then samples random workloads (query mixes),
derives the state vector from the per-query statistics, and computes the
reward analytically from historical latencies — "like a database simulator".

We reproduce that design: a :class:`QueryStat` library (either measured from
our engine runs or synthesized), a workload sampler, and the reward =
throughput speedup vs. the historical average (paper's reward function).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..features import NUM_FEATURES, build_state, state_dim


@dataclass
class QueryStat:
    """Historical statistics of one query w.r.t. the candidate library."""
    query_id: str
    candidates: List[int]           # indices of candidates this query desires
    base_latency: float             # CPU-side latency (s), shuffle excluded
    shuffle_bytes: float            # bytes moved if its shuffle is NOT elided
    input_bytes: float
    # per-candidate stats (selectivity, distinct keys) for feature synthesis
    selectivity: Dict[int, float] = field(default_factory=dict)
    distinct_keys: Dict[int, float] = field(default_factory=dict)
    distance: float = 60.0          # mean inter-arrival (s)
    frequency: float = 10.0
    recency: float = 0.0


@dataclass
class SimConfig:
    num_candidates: int = 12        # K candidate slots (incl. rr + random)
    net_bandwidth: float = 1.25e9   # bytes/s (10 Gbps, paper's clusters)
    partition_overhead: float = 0.10  # ≤10% producer overhead (paper Tab. 3)
    queries_per_workload: Tuple[int, int] = (1, 4)
    seed: int = 0


class TraceSimulator:
    """Samples workloads and scores partitioning actions.

    Action space: index into the candidate library; the last two indices are
    always round-robin and random (keyless)."""

    def __init__(self, queries: Sequence[QueryStat], cfg: SimConfig,
                 complexities: Optional[Sequence[float]] = None):
        self.queries = list(queries)
        self.cfg = cfg
        self.K = cfg.num_candidates
        self.rr_action = self.K - 2
        self.rand_action = self.K - 1
        self.complexities = (list(complexities) if complexities is not None
                             else [1.0] * (self.K - 2)) + [0.0, 0.0]
        self._rng = np.random.default_rng(cfg.seed)
        # historical average throughput = every query run un-partitioned
        tot_b = sum(q.input_bytes * q.frequency for q in self.queries)
        tot_l = sum(self._latency(q, elided=False) * q.frequency
                    for q in self.queries)
        self.baseline_throughput = tot_b / tot_l

    # -- cost model -----------------------------------------------------------
    def _latency(self, q: QueryStat, elided: bool) -> float:
        shuffle = 0.0 if elided else q.shuffle_bytes / self.cfg.net_bandwidth
        return q.base_latency + shuffle

    # -- episode API -------------------------------------------------------------
    def sample_workload(self) -> List[Tuple[QueryStat, float]]:
        lo, hi = self.cfg.queries_per_workload
        n = int(self._rng.integers(lo, hi + 1))
        idx = self._rng.choice(len(self.queries), size=min(n, len(self.queries)),
                               replace=False)
        return [(self.queries[i], float(self._rng.uniform(0.3, 1.0)))
                for i in idx]

    def state_of(self, workload) -> Tuple[np.ndarray, np.ndarray]:
        """Build (state, action_mask).  Feature aggregation per §4.3: averages
        for distance/frequency/recency, max selectivity, min distinct keys."""
        rows = np.zeros((self.K, NUM_FEATURES), np.float32)
        mask = np.zeros((self.K,), bool)
        mask[self.rr_action] = mask[self.rand_action] = True
        total_objs = sum(q.input_bytes for q, _f in workload) / 64.0
        for k in range(self.K - 2):
            qs = [(q, f) for q, f in workload if k in q.candidates]
            if not qs:
                continue
            mask[k] = True
            rows[k, 0] = np.mean([q.distance for q, _ in qs])
            rows[k, 1] = np.sum([q.frequency * f for q, f in qs])
            rows[k, 2] = np.max([q.recency for q, _ in qs])
            rows[k, 3] = self.complexities[k]
            rows[k, 4] = np.max([q.selectivity.get(k, 0.0) for q, _ in qs])
            rows[k, 5] = np.min([q.distinct_keys.get(k, 1.0) for q, _ in qs])
        # keyless rows: complexity 0, selectivity 1, key_dist = avg #elements
        for k in (self.rr_action, self.rand_action):
            rows[k, 4] = 1.0
            rows[k, 5] = total_objs
        dataset_bytes = sum(q.input_bytes for q, _f in workload)
        state = _rows_to_state(rows, dataset_bytes)
        return state, mask

    def reward_of(self, workload, action: int) -> float:
        """Paper's reward: throughput with the chosen partitioning divided by
        the historical-average (baseline) throughput."""
        tot_b, tot_l = 0.0, 0.0
        keyed = action < self.K - 2
        for q, f in workload:
            elided = keyed and (action in q.candidates)
            lat = self._latency(q, elided)
            if keyed:
                lat *= (1.0 + self.cfg.partition_overhead /
                        max(1.0, q.frequency))
            # skew penalty: few distinct keys → imbalance stretches latency
            if elided:
                dk = q.distinct_keys.get(action, 64.0)
                lat *= 1.0 + max(0.0, (8.0 - dk)) / 8.0
            tot_b += q.input_bytes * q.frequency * f
            tot_l += lat * q.frequency * f
        return (tot_b / tot_l) / self.baseline_throughput

    def best_action(self, workload) -> int:
        _, mask = self.state_of(workload)
        rewards = [self.reward_of(workload, a) if mask[a] else -np.inf
                   for a in range(self.K)]
        return int(np.argmax(rewards))

    @property
    def state_dim(self) -> int:
        return state_dim(self.K)


def _rows_to_state(rows: np.ndarray, dataset_bytes: float) -> np.ndarray:
    out = rows.copy()
    out[:, 0] = np.log1p(rows[:, 0])
    out[:, 1] = np.log1p(rows[:, 1])
    out[:, 2] = 1.0 / (1.0 + np.log1p(np.maximum(rows[:, 2], 0)))
    out[:, 3] = rows[:, 3] / 10.0
    out[:, 5] = np.log1p(rows[:, 5]) / 20.0
    return np.concatenate([out.reshape(-1),
                           [np.float32(np.log1p(dataset_bytes) / 30.0)]]
                          ).astype(np.float32)


# ---------------------------------------------------------------------------
# Synthetic TPC-H-like trace library (stand-in for the paper's 1293 measured
# runs; the shape — queries × candidates × latencies — is identical).
# ---------------------------------------------------------------------------

def tpch_like_library(num_queries: int = 10, num_keyed: int = 10,
                      seed: int = 7) -> Tuple[List[QueryStat], SimConfig]:
    rng = np.random.default_rng(seed)
    queries = []
    for i in range(num_queries):
        cands = sorted(rng.choice(num_keyed,
                                  size=int(rng.integers(1, 4)),
                                  replace=False).tolist())
        inp = float(rng.uniform(1, 12)) * 1e9
        queries.append(QueryStat(
            query_id=f"Q{i+1:02d}",
            candidates=cands,
            base_latency=float(rng.uniform(4, 40)),
            shuffle_bytes=inp * float(rng.uniform(0.1, 0.9)),
            input_bytes=inp,
            selectivity={k: float(rng.uniform(0.02, 0.6)) for k in cands},
            distinct_keys={k: float(rng.uniform(2, 1e6)) for k in cands},
            distance=float(rng.uniform(10, 600)),
            frequency=float(rng.integers(1, 40)),
            recency=float(rng.uniform(0, 1e4)),
        ))
    return queries, SimConfig(num_candidates=num_keyed + 2, seed=seed)
