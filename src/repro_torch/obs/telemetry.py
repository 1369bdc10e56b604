"""Durable telemetry history — the (state, action, reward) substrate
(DESIGN §15).

A :class:`TelemetryStore` lives under the store root
(``<root>/telemetry/``) and appends one :class:`RunProfile` record per
executed run — wall, shuffle and IO seconds, plan-cache hit/miss,
retrace count, padded/valid bytes, placement epoch and the per-dataset
generation pins the plan keyed on — plus per-tick Autopilot snapshots.
Unlike ``decisions.log`` (an audit trail, fsync'd per record), telemetry
is advisory: appends flush but do not fsync, and the file is **bounded**
— when it outgrows ``max_records`` plus slack, a compaction folds the
evicted run records into one aggregate ``summary`` record and atomically
rewrites the file, so a long-lived service never grows it without bound
(the same fold-into-aggregate idiom the Observer's HistoryStore uses).

The append path is the per-run overhead: one ``json.dumps`` + one write
on an already-open handle.

This file is the stream a DRL advisor trains from: each record pairs the
observed state (bytes, skew, epoch), the decision context (generations),
and the reward (wall seconds).  The file format is the JAX package's, so
a history written by either package reads in the other.

The same directory also aggregates **cluster metrics**: each process
exports its registry snapshot to ``metrics-<node>.json``
(:meth:`TelemetryStore.write_node_metrics`) and
:meth:`TelemetryStore.cluster_metrics` merges them into one snapshot
with a ``node`` label on every sample, renderable as Prometheus text.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from .metrics import (MetricsRegistry, merge_node_snapshots,
                      snapshot_prometheus_text)
from .tracer import TraceContext

__all__ = ["RunProfile", "TelemetryStore", "TELEMETRY_SCHEMA_VERSION"]

#: schema version stamped into every telemetry record; the loader skips
#: (and warns about) records from a future version, tolerates older ones
TELEMETRY_SCHEMA_VERSION = 1


@dataclass
class RunProfile:
    """One executed run, profiled.  All fields default so records written
    by older versions (or hand-rolled in tests) still load."""
    t: float = 0.0                    # wall-clock stamp (unix seconds)
    workload: str = ""                # Workload app_id
    process: str = ""                 # tracer process label
    wall_s: float = 0.0
    shuffle_s: float = 0.0
    io_s: float = 0.0
    planning_s: float = 0.0
    plan_cache_hit: Optional[bool] = None
    retraces: int = 0                 # device traces added by this run
    shuffles_performed: int = 0
    shuffles_elided: int = 0
    shuffle_bytes: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    io_bytes: int = 0                 # storage bytes rehydrated
    padded_bytes: int = 0
    valid_bytes: int = 0
    placement_epoch: int = -1         # cluster directory epoch (-1 = none)
    generations: Dict[str, int] = field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "RunProfile":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in rec.items() if k in known})


class TelemetryStore:
    """Bounded, compacting JSONL history under ``<root>/telemetry/``."""

    def __init__(self, root: str, max_records: int = 4096,
                 compact_slack: Optional[int] = None):
        if max_records < 1:
            raise ValueError("max_records must be >= 1")
        self.dir = os.path.join(root, "telemetry")
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "runs.jsonl")
        self.max_records = int(max_records)
        # compact lazily: let the file overshoot by `slack` records so the
        # rewrite amortizes instead of firing on every append past the cap
        self.compact_slack = (max(1, max_records // 4)
                              if compact_slack is None else int(compact_slack))
        self._lock = threading.Lock()
        self._f = None                        # lazily-opened append handle
        self._count = self._count_existing()
        self._seq = self._count
        self.appends = 0
        self.compactions = 0

    # -- internals -----------------------------------------------------------
    def _count_existing(self) -> int:
        try:
            with open(self.path, "rb") as f:
                return sum(1 for _ in f)
        except OSError:
            return 0

    def _handle(self):
        # caller holds _lock
        if self._f is None:
            self._f = open(self.path, "a")
        return self._f

    def _append(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec) + "\n"
        with self._lock:
            f = self._handle()
            f.write(line)
            f.flush()                         # advisory: no fsync
            self._count += 1
            self.appends += 1
            if self._count > self.max_records + self.compact_slack:
                self._compact_locked()

    # -- recording -----------------------------------------------------------
    def record_run(self, profile: RunProfile) -> None:
        """Append one per-run profile (the hot path — bounded cost)."""
        rec = profile.to_record()
        rec["v"] = TELEMETRY_SCHEMA_VERSION
        rec["kind"] = "run"
        self._seq += 1
        rec["seq"] = self._seq
        self._append(rec)

    def record_tick(self, payload: Dict[str, Any]) -> None:
        """Append one Autopilot tick snapshot."""
        rec = dict(payload)
        rec["v"] = TELEMETRY_SCHEMA_VERSION
        rec["kind"] = "tick"
        rec.setdefault("t", time.time())
        self._seq += 1
        rec["seq"] = self._seq
        self._append(rec)

    # -- reading -------------------------------------------------------------
    def records(self, kind: Optional[str] = None,
                limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """All records oldest-first (tolerant loader: torn lines skipped,
        future-version records skipped with one warning)."""
        out: List[Dict[str, Any]] = []
        warned = False
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return out
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue                      # torn tail — ignore
            if not isinstance(rec, dict):
                continue
            if int(rec.get("v", 1)) > TELEMETRY_SCHEMA_VERSION:
                if not warned:
                    warnings.warn(
                        f"telemetry record version {rec.get('v')} > "
                        f"supported {TELEMETRY_SCHEMA_VERSION}; skipping",
                        stacklevel=2)
                    warned = True
                continue
            if kind is not None and rec.get("kind") != kind:
                continue
            out.append(rec)
        if limit is not None:
            out = out[-int(limit):]
        return out

    def run_profiles(self, limit: Optional[int] = None) -> List[RunProfile]:
        return [RunProfile.from_record(r)
                for r in self.records(kind="run", limit=limit)]

    def summary(self) -> Optional[Dict[str, Any]]:
        """The compaction aggregate, if any evictions have happened."""
        recs = self.records(kind="summary")
        return recs[-1] if recs else None

    # -- compaction ----------------------------------------------------------
    def compact(self) -> int:
        """Fold all but the newest ``max_records`` records into the
        aggregate summary; returns the number of records evicted."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        recs = self.records()
        keep_from = max(0, len(recs) - self.max_records)
        evicted, kept = recs[:keep_from], recs[keep_from:]
        if not evicted:
            self._count = len(recs)
            return 0
        # fold evicted runs (and any prior summary) into one aggregate
        agg = {"v": TELEMETRY_SCHEMA_VERSION, "kind": "summary",
               "runs": 0, "ticks": 0, "wall_s_sum": 0.0,
               "shuffle_s_sum": 0.0, "io_s_sum": 0.0,
               "cache_hits": 0, "retraces": 0,
               "first_t": None, "last_t": None}
        for rec in evicted:
            k = rec.get("kind")
            if k == "summary":
                for key in ("runs", "ticks", "cache_hits", "retraces"):
                    agg[key] += int(rec.get(key, 0))
                for key in ("wall_s_sum", "shuffle_s_sum", "io_s_sum"):
                    agg[key] += float(rec.get(key, 0.0))
                if rec.get("first_t") is not None:
                    agg["first_t"] = rec["first_t"] if agg["first_t"] is None \
                        else min(agg["first_t"], rec["first_t"])
                if rec.get("last_t") is not None:
                    agg["last_t"] = rec["last_t"] if agg["last_t"] is None \
                        else max(agg["last_t"], rec["last_t"])
                continue
            t = rec.get("t")
            if t is not None:
                agg["first_t"] = t if agg["first_t"] is None \
                    else min(agg["first_t"], t)
                agg["last_t"] = t if agg["last_t"] is None \
                    else max(agg["last_t"], t)
            if k == "tick":
                agg["ticks"] += 1
                continue
            agg["runs"] += 1
            agg["wall_s_sum"] += float(rec.get("wall_s", 0.0))
            agg["shuffle_s_sum"] += float(rec.get("shuffle_s", 0.0))
            agg["io_s_sum"] += float(rec.get("io_s", 0.0))
            agg["cache_hits"] += 1 if rec.get("plan_cache_hit") else 0
            agg["retraces"] += int(rec.get("retraces", 0))
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(agg) + "\n")
            for rec in kept:
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        if self._f is not None:               # reopen: old handle points at
            self._f.close()                   # the unlinked inode
            self._f = None
        self._count = len(kept) + 1
        self.compactions += 1
        return len(evicted)

    # -- stats / metrics -----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"records": self._count, "appends": self.appends,
                    "compactions": self.compactions,
                    "max_records": self.max_records, "path": self.path}

    # -- trace-context carrier (cross-process stitching) ---------------------
    def save_trace_context(self, ctx: TraceContext, name: str) -> str:
        """Persist a wire-format TraceContext under the telemetry dir so
        a later process can pick it up (``load_trace_context``)."""
        path = os.path.join(self.dir, f"context-{name}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ctx.to_wire(), f)
        os.replace(tmp, path)
        return path

    def load_trace_context(self, name: str) -> Optional[TraceContext]:
        path = os.path.join(self.dir, f"context-{name}.json")
        try:
            with open(path) as f:
                return TraceContext.from_wire(json.load(f))
        except (OSError, ValueError, KeyError):
            return None

    # -- cluster metrics aggregation -----------------------------------------
    def write_node_metrics(self, registry: MetricsRegistry,
                           node: str) -> str:
        """Snapshot a registry to ``metrics-<node>.json`` (atomic)."""
        path = os.path.join(self.dir, f"metrics-{_safe(node)}.json")
        doc = {"node": node, "snapshot": registry.snapshot()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    def node_metrics(self) -> Dict[str, Dict[str, Any]]:
        """All per-node snapshots: ``{node: snapshot}``."""
        out: Dict[str, Dict[str, Any]] = {}
        import glob as _glob
        for path in sorted(_glob.glob(
                os.path.join(self.dir, "metrics-*.json"))):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(doc, dict) and "snapshot" in doc:
                node = str(doc.get("node")
                           or os.path.basename(path)[len("metrics-"):-5])
                out[node] = doc["snapshot"]
        return out

    def cluster_metrics(self) -> Dict[str, Any]:
        """Merged view over every node snapshot: one metrics document
        with a ``node`` label added to every sample."""
        return merge_node_snapshots(self.node_metrics())

    def cluster_metrics_text(self) -> str:
        """The merged view as Prometheus text exposition."""
        return snapshot_prometheus_text(self.cluster_metrics())


def _safe(label: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "_" for c in label)
