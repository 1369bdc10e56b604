"""End-to-end partitioning creation (paper Alg. 3) + selector policies.

``partitioning_creation`` wires together: workload enumeration (history
skeleton graph) → candidate enumeration (Alg. 1+2 per consumer IR) →
feature extraction → selection (DRL agent or greedy Eq. 2 cost model) →
a :class:`PartitioningDecision` the storage layer applies at write time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .features import CandidateFeatures, build_state, candidate_features
from .history import HistoryStore, SkeletonNode
from .partitioner import (PartitionerCandidate, dedupe, enumerate_candidates,
                          keyless_candidates)


@dataclass
class PartitioningDecision:
    dataset: str
    candidate: PartitionerCandidate
    features: List[CandidateFeatures]
    consumers: List[str]                 # skeleton group signatures
    action_index: int
    state: np.ndarray
    elapsed_s: float                     # advisor online overhead (producer side)


class GreedySelector:
    """Eq. 2 baseline: pick argmin of estimated producer + Σ freq·latency.

    Latency estimate per consumer group: historical mean latency, minus the
    modeled shuffle time when the candidate matches that group's desired
    partitioner (selectivity × input bytes over net bandwidth)."""

    def __init__(self, net_bandwidth: float = 1.25e9,
                 partition_overhead: float = 0.10):
        self.net_bandwidth = net_bandwidth
        self.partition_overhead = partition_overhead

    def select(self, feats: Sequence[CandidateFeatures],
               groups: Sequence[SkeletonNode], dataset_bytes: float,
               state: np.ndarray) -> int:
        best, best_cost = 0, float("inf")
        for i, f in enumerate(feats):
            cand = f.candidate
            producer = dataset_bytes / self.net_bandwidth * \
                (self.partition_overhead if cand.is_keyed else 0.0)
            consumer = 0.0
            for g in groups:
                runs = g.runs
                if not runs:
                    continue
                # weight-aware (compacted records stand for `weight` runs)
                wsum = float(sum(r.weight for r in runs))
                mean_lat = float(sum(r.weight * r.latency
                                     for r in runs)) / wsum
                freq = wsum
                saved = 0.0
                if cand.is_keyed and any(
                        cand.signature() in r.candidate_stats for r in runs):
                    # an avoided shuffle moves ~the whole dataset once per
                    # consumer run (Eq. 2's freq_k × lat_k delta)
                    saved = min(mean_lat * 0.9,
                                dataset_bytes / self.net_bandwidth)
                consumer += freq * (mean_lat - saved)
            cost = producer + consumer
            if cost < best_cost:
                best, best_cost = i, cost
        return best


class DRLSelector:
    """Wraps an :class:`~repro_torch.core.drl.agent.A3CAgent` (paper
    §3.1.3), or any object with ``cfg.num_actions`` and ``select(state,
    mask, greedy=)``."""

    def __init__(self, agent, greedy: bool = True):
        self.agent = agent
        self.greedy = greedy

    def select(self, feats, groups, dataset_bytes, state) -> int:
        mask = np.zeros((self.agent.cfg.num_actions,), bool)
        mask[:len(feats)] = True
        return self.agent.select(state, mask, greedy=self.greedy)


def partitioning_creation(producer, dataset: str, history: HistoryStore,
                          selector=None, *, dataset_bytes: float = 0.0,
                          max_candidates: int = 12,
                          now: Optional[float] = None) -> PartitioningDecision:
    """Alg. 3.  ``producer`` is a traced Workload about to write ``dataset``."""
    t0 = time.perf_counter()
    now = now if now is not None else time.time()
    selector = selector or GreedySelector()

    # line 4: W ← match(p, W')  — consumers of past outputs of this producer IR
    psig = producer.graph.graph_signature()
    groups = history.enumerate_consumers(psig)

    # lines 5–11: candidate enumeration over every consumer IR
    cands: List[PartitionerCandidate] = []
    cand_groups: Dict[str, List[SkeletonNode]] = {}
    for g in groups:
        ir = history.ir_of(g.ir_signature)
        if ir is None:
            continue
        for c in enumerate_candidates(ir, dataset):
            cands.append(c)
            cand_groups.setdefault(c.signature(), []).append(g)
    cands = dedupe(cands)
    cands.extend(keyless_candidates())       # rr + random always in the space

    feats = [candidate_features(c, cand_groups.get(c.signature(), groups
                                                   if not c.is_keyed else []),
                                history, now)
             for c in cands]
    state = build_state(feats, dataset_bytes, max_candidates, now=now)

    # line 12: g_opt ← selector
    action = selector.select(feats, groups, dataset_bytes, state)
    action = min(action, len(feats) - 1)

    return PartitioningDecision(
        dataset=dataset, candidate=feats[action].candidate, features=feats,
        consumers=[g.ir_signature for g in groups], action_index=action,
        state=state, elapsed_s=time.perf_counter() - t0)


def apply_decision(store, decision: PartitioningDecision, *, mesh=None,
                   swap: bool = True):
    """Apply a :class:`PartitioningDecision` to a live store: repartition
    the dataset into the decided layout (device-to-device when both store
    and dataset are device-backed) and — with ``swap=True`` — atomically
    flip the dataset to the new generation so readers never observe a
    half-shuffled table (DESIGN §8).  Returns ``(new_dataset, bytes_moved)``.

    ``mesh`` (a ``core.sharding_bridge.Mesh`` of any number of devices)
    places the result on it, as ``PartitionStore.repartition(mesh=)`` does;
    a dataset already placed on a mesh is repartitioned shard to shard."""
    ds = store.read(decision.dataset)
    return store.repartition(ds, decision.candidate, mesh=mesh, swap=swap)
