"""Historical workflow analyzer (paper §3.1.1, §4.2).

Reconstructs the low-level workflow graph from execution logs (node =
(app_id, timestamp) execution, edge = dataset produced by src and consumed
by dst), condenses it into a *skeleton graph* by merging executions whose IR
signatures are equal, and answers the workload-enumeration query: given a
producer about to write a dataset, which historical workloads will likely
consume it?
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field, asdict
from typing import Dict, List, Optional, Set, Tuple

from .ir import IRGraph


@dataclass
class ExecutionRecord:
    """One execution of a workload (one node of the low-level graph).

    ``weight`` is the number of real executions this record stands for: 1
    for a live run, >1 for an aggregate produced by :meth:`HistoryStore.
    compact` (latency/bytes then hold the weighted means of the merged
    runs, ``timestamp`` their most recent)."""
    app_id: str
    timestamp: float
    ir_signature: str
    inputs: List[str] = field(default_factory=list)    # dataset ids read
    outputs: List[str] = field(default_factory=list)   # dataset ids written
    latency: float = 0.0                               # seconds
    input_bytes: float = 0.0
    output_bytes: float = 0.0
    # padded-layout accounting over the datasets this run scanned (DESIGN
    # §12): the padded-vs-valid gap feeds the cost model's padding term
    padded_bytes: float = 0.0
    valid_bytes: float = 0.0
    # per-candidate runtime stats observed in this run, keyed by candidate
    # signature: {"selectivity": float, "distinct_keys": float,
    #             "key_bytes": float, "object_bytes": float}
    candidate_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    weight: float = 1.0


@dataclass
class SkeletonNode:
    """A group of executions sharing one IR signature (Fig. 3b)."""
    group_id: int
    ir_signature: str
    runs: List[ExecutionRecord] = field(default_factory=list)

    @property
    def app_ids(self) -> Set[str]:
        return {r.app_id for r in self.runs}


class HistoryStore:
    """Append-only execution log + derived graphs.

    The store optionally persists to a JSONL file so history survives process
    restarts (the paper's write-once/read-many premise needs durability).
    """

    def __init__(self, path: Optional[str] = None):
        self.records: List[ExecutionRecord] = []
        self.irs: Dict[str, IRGraph] = {}          # ir_signature -> IR graph
        self.path = path
        self._lock = threading.Lock()   # appends vs compaction (service)
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    self.records.append(ExecutionRecord(**json.loads(line)))

    # -- logging ----------------------------------------------------------------
    def log(self, record: ExecutionRecord, ir: Optional[IRGraph] = None) -> None:
        with self._lock:
            self.records.append(record)
            if ir is not None:
                self.irs[record.ir_signature] = ir
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(asdict(record)) + "\n")

    def log_workload(self, workload, *, timestamp: float, latency: float = 0.0,
                     input_bytes: float = 0.0, output_bytes: float = 0.0,
                     padded_bytes: float = 0.0, valid_bytes: float = 0.0,
                     candidate_stats: Optional[Dict] = None) -> ExecutionRecord:
        g = workload.graph
        rec = ExecutionRecord(
            app_id=workload.app_id, timestamp=timestamp,
            ir_signature=g.graph_signature(),
            inputs=[g.nodes[s].params["dataset"] for s in g.scans],
            outputs=[g.nodes[o].params["dataset"] for o in g.writes],
            latency=latency, input_bytes=input_bytes,
            output_bytes=output_bytes,
            padded_bytes=padded_bytes, valid_bytes=valid_bytes,
            candidate_stats=candidate_stats or {})
        self.log(rec, ir=g)
        return rec

    # -- low-level workflow graph (Fig. 3a) -----------------------------------------
    def low_level_graph(self) -> List[Tuple[int, int, str]]:
        """Edges (producer_idx, consumer_idx, dataset) between executions."""
        edges = []
        producers: Dict[str, List[int]] = {}
        for i, r in enumerate(self.records):
            for d in r.outputs:
                producers.setdefault(d, []).append(i)
        for j, r in enumerate(self.records):
            for d in r.inputs:
                for i in producers.get(d, []):
                    # producer must precede the consumer
                    if self.records[i].timestamp <= r.timestamp and i != j:
                        edges.append((i, j, d))
        return edges

    # -- skeleton graph (Fig. 3b) -----------------------------------------------------
    def skeleton_graph(self) -> Tuple[Dict[str, SkeletonNode],
                                      Set[Tuple[str, str]]]:
        groups: Dict[str, SkeletonNode] = {}
        for r in self.records:
            if r.ir_signature not in groups:
                groups[r.ir_signature] = SkeletonNode(len(groups), r.ir_signature)
            groups[r.ir_signature].runs.append(r)
        edges: Set[Tuple[str, str]] = set()
        idx = {i: r.ir_signature for i, r in enumerate(self.records)}
        for i, j, _d in self.low_level_graph():
            edges.add((idx[i], idx[j]))
        return groups, edges

    # -- workload enumeration (§3.1.1) ---------------------------------------------------
    def enumerate_consumers(self, producer_signature: str) -> List[SkeletonNode]:
        """Workloads W that historically consumed outputs of executions whose
        IR signature matches the producer's — the future-consumer prediction."""
        groups, edges = self.skeleton_graph()
        if producer_signature not in groups:
            return []
        out = [groups[dst] for (src, dst) in edges
               if src == producer_signature and dst in groups]
        # dedupe, stable order by group id
        seen, uniq = set(), []
        for g in out:
            if g.group_id not in seen:
                seen.add(g.group_id)
                uniq.append(g)
        return sorted(uniq, key=lambda g: g.group_id)

    def ir_of(self, signature: str) -> Optional[IRGraph]:
        return self.irs.get(signature)

    # -- compaction (bounds the append-only log) --------------------------------
    def compact(self, max_records: int) -> int:
        """Bound the log: keep the newest ``max_records`` records verbatim
        and merge everything older into one aggregate record per skeleton
        group (IR signature), preserving weighted means, total weight and
        the most recent timestamp.  Returns the number of records removed.

        Post-compaction size is ``max_records + (#distinct old skeletons)``
        — bounded by the (small, stable) skeleton count, so a service
        appending every run can compact periodically and the log never
        grows without limit.  When the store is file-backed the JSONL is
        atomically rewritten (tmp + rename)."""
        with self._lock:
            if max_records < 0:
                raise ValueError("max_records must be >= 0")
            if len(self.records) <= max_records:
                return 0
            cut = len(self.records) - max_records
            old, keep = self.records[:cut], self.records[cut:]
            merged: Dict[str, ExecutionRecord] = {}
            order: List[str] = []
            for r in old:
                agg = merged.get(r.ir_signature)
                if agg is None:
                    merged[r.ir_signature] = _copy_record(r)
                    order.append(r.ir_signature)
                else:
                    _merge_record(agg, r)
            self.records = [merged[s] for s in order] + keep
            removed = cut - len(merged)
            if self.path:
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    for r in self.records:
                        f.write(json.dumps(asdict(r)) + "\n")
                os.replace(tmp, self.path)
            return removed

    # -- simple aggregates used by features.py ----------------------------------------------
    def runs_of_group(self, signature: str) -> List[ExecutionRecord]:
        return [r for r in self.records if r.ir_signature == signature]

    def total_runs(self) -> float:
        """Number of executions represented (compaction-aware)."""
        return float(sum(r.weight for r in self.records))

    def overall_throughput(self) -> float:
        """Baseline throughput (bytes/s) over all history — reward denominator."""
        total_bytes = sum(r.weight * r.input_bytes for r in self.records)
        total_lat = sum(r.weight * r.latency for r in self.records)
        return total_bytes / total_lat if total_lat > 0 else 0.0


def _copy_record(r: ExecutionRecord) -> ExecutionRecord:
    return ExecutionRecord(
        app_id=r.app_id, timestamp=r.timestamp, ir_signature=r.ir_signature,
        inputs=list(r.inputs), outputs=list(r.outputs), latency=r.latency,
        input_bytes=r.input_bytes, output_bytes=r.output_bytes,
        padded_bytes=r.padded_bytes, valid_bytes=r.valid_bytes,
        candidate_stats={k: dict(v) for k, v in r.candidate_stats.items()},
        weight=r.weight)


def _merge_record(agg: ExecutionRecord, r: ExecutionRecord) -> None:
    """Fold ``r`` into the aggregate ``agg`` (same IR signature).

    Scalars become weighted means; per-candidate stats follow the feature
    aggregation semantics of features.py (max selectivity, min distinct
    keys) so max/min over the compacted log equal max/min over the raw
    runs it replaced."""
    w = agg.weight + r.weight
    agg.latency = (agg.weight * agg.latency + r.weight * r.latency) / w
    agg.input_bytes = (agg.weight * agg.input_bytes
                       + r.weight * r.input_bytes) / w
    agg.output_bytes = (agg.weight * agg.output_bytes
                        + r.weight * r.output_bytes) / w
    agg.padded_bytes = (agg.weight * agg.padded_bytes
                        + r.weight * r.padded_bytes) / w
    agg.valid_bytes = (agg.weight * agg.valid_bytes
                       + r.weight * r.valid_bytes) / w
    agg.timestamp = max(agg.timestamp, r.timestamp)
    for d in r.inputs:
        if d not in agg.inputs:
            agg.inputs.append(d)
    for d in r.outputs:
        if d not in agg.outputs:
            agg.outputs.append(d)
    for sig, st in r.candidate_stats.items():
        cur = agg.candidate_stats.setdefault(sig, dict(st))
        if cur is not st:
            for k, v in st.items():
                if k == "distinct_keys" and k in cur:
                    cur[k] = min(cur[k], v)
                elif k in cur:
                    cur[k] = max(cur[k], v)
                else:
                    cur[k] = v
    agg.weight = w
