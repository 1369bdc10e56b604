"""State feature vector for partitioner candidates (paper §3.1.3).

Per candidate: (distance, frequency, recency, complexity, selectivity,
key_distribution), plus the dataset-size estimate e_t appended to the state.
Keyless candidates (round-robin / random) get complexity = 0, selectivity =
1, key_distribution = avg number of elements in historical runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .history import HistoryStore, SkeletonNode
from .partitioner import PartitionerCandidate

FEATURE_NAMES = ("distance", "frequency", "recency", "complexity",
                 "selectivity", "key_distribution")
NUM_FEATURES = len(FEATURE_NAMES)


@dataclass
class CandidateFeatures:
    candidate: PartitionerCandidate
    distance: float          # avg interval between most recent k runs
    frequency: float         # total historical executions of the origin IR
    recency: float           # timestamp of most recent run
    complexity: float        # shortest-path weight sum of the subgraph
    selectivity: float       # avg key bytes / avg object bytes
    key_distribution: float  # avg distinct hashed keys in historical runs

    def vector(self) -> np.ndarray:
        return np.array([self.distance, self.frequency, self.recency,
                         self.complexity, self.selectivity,
                         self.key_distribution], dtype=np.float32)


def candidate_features(cand: PartitionerCandidate,
                       groups: Sequence[SkeletonNode],
                       history: HistoryStore,
                       now: float,
                       recent_k: int = 5) -> CandidateFeatures:
    """Features of one candidate aggregated over the skeleton groups whose
    IRs contain it.  Aggregation follows §4.3: averages for distance/
    frequency/recency, max for selectivity, min for key distribution."""
    runs = [r for g in groups for r in g.runs]
    runs.sort(key=lambda r: r.timestamp)
    sig = cand.signature()

    if runs:
        # compaction-aware: an aggregate record stands for `weight` runs
        freq = float(sum(r.weight for r in runs))
        recency = runs[-1].timestamp
        recent = [r.timestamp for r in runs[-recent_k:]]
        distance = (float(np.mean(np.diff(recent))) if len(recent) > 1 else 0.0)
    else:
        freq, recency, distance = 0.0, 0.0, 0.0

    sel_samples, key_samples, count_samples = [], [], []
    for r in runs:
        st = r.candidate_stats.get(sig)
        if st:
            if "selectivity" in st:
                sel_samples.append(st["selectivity"])
            elif st.get("object_bytes"):
                sel_samples.append(st.get("key_bytes", 0.0) / st["object_bytes"])
            if "distinct_keys" in st:
                key_samples.append(st["distinct_keys"])
        if r.input_bytes:
            count_samples.append(st.get("num_objects", 0.0) if st else 0.0)

    if not cand.is_keyed:
        complexity = 0.0
        selectivity = 1.0
        key_dist = float(np.mean([c for c in count_samples if c > 0])) \
            if any(c > 0 for c in count_samples) else 0.0
    else:
        complexity = float(cand.complexity())
        selectivity = float(np.max(sel_samples)) if sel_samples else 0.0
        key_dist = float(np.min(key_samples)) if key_samples else 0.0

    return CandidateFeatures(cand, distance, freq, recency, complexity,
                             selectivity, key_dist)


def build_state(feats: Sequence[CandidateFeatures], dataset_bytes: float,
                max_candidates: int, now: float = 0.0) -> np.ndarray:
    """State s_t = (d, f, r, c, s, k per candidate ‖ e_t), zero-padded /
    truncated to ``max_candidates`` rows, normalized for network input."""
    rows = np.zeros((max_candidates, NUM_FEATURES), dtype=np.float32)
    for i, f in enumerate(feats[:max_candidates]):
        rows[i] = f.vector()
    # normalization: log-scale counts/sizes, recency as age
    out = rows.copy()
    out[:, 0] = np.log1p(rows[:, 0])                  # distance
    out[:, 1] = np.log1p(rows[:, 1])                  # frequency
    age = np.where(rows[:, 2] > 0, now - rows[:, 2], 1e6)
    out[:, 2] = 1.0 / (1.0 + np.log1p(np.maximum(age, 0)))  # recency → freshness
    out[:, 3] = rows[:, 3] / 10.0                     # complexity
    out[:, 4] = rows[:, 4]                            # selectivity ∈ [0, ~1]
    out[:, 5] = np.log1p(rows[:, 5]) / 20.0           # key distribution
    state = np.concatenate([out.reshape(-1),
                            np.array([np.log1p(dataset_bytes) / 30.0],
                                     dtype=np.float32)])
    return state


def state_dim(max_candidates: int) -> int:
    return max_candidates * NUM_FEATURES + 1
