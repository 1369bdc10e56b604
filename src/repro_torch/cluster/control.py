"""Cluster control plane — health signals the Autopilot can price.

This module is the wiring layer that turns the three previously-dormant
runtime modules into the cluster tier's failure/straggler detector:

* :mod:`repro_torch.runtime.fault_tolerance` — ``Coordinator`` heartbeats:
  a node that misses ``miss_threshold`` consecutive control-plane ticks
  is declared lost.
* :mod:`repro_torch.runtime.straggler` — ``StragglerMitigator``'s p50-window
  detector, fed by per-part segment read latencies from the multi-node
  store: a node whose reads repeatedly exceed ``factor × p50`` is a
  straggler (reads are transparently reissued against a replica holder;
  persistent slowness escalates to a signal).
* :mod:`repro_torch.runtime.elastic` — consumed by the Rebalancer, which
  converts a membership change into a mesh replan.

Detection does NOT act.  It emits :class:`ClusterSignal` values that the
Autopilot drains on its next tick (`signals()`), prices with the what-if
cost model, and answers with a rebalance decision — the same
observe→price→decide→apply loop every other layout decision takes, so a
lost node shows up in ``decisions.log`` with a full why-record.

Determinism: the clock is a logical step counter the caller advances
(``tick(step)``), latencies can be injected per node
(``set_read_latency``), so every failure mode is reproducible on one
host with no sleeps.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.fault_tolerance import Coordinator, FailureEvent
from ..runtime.straggler import StragglerConfig, StragglerMitigator

__all__ = ["ClusterSignal", "ClusterHealth"]

#: a node must straggle this many reads (within the mitigator window)
#: before detection escalates from per-read reissue to a cluster signal
STRAGGLER_SIGNAL_DETECTIONS = 3


@dataclass
class ClusterSignal:
    """One health event awaiting an Autopilot decision."""
    kind: str                     # "node_lost" | "straggler"
    node: str
    step: int
    detail: Dict[str, float] = field(default_factory=dict)


class ClusterHealth:
    """Heartbeat + straggler tracking over a named node set.

    Thread-safety: the store's read path calls :meth:`record_read` from
    serving threads while the Autopilot thread drives :meth:`tick` /
    :meth:`signals`; one lock serializes all state transitions (none of
    them are hot — reads take the lock once per *segment part*, not per
    row)."""

    def __init__(self, nodes: Sequence[str], *, miss_threshold: int = 3,
                 straggler: Optional[StragglerConfig] = None,
                 straggler_signal_detections: int =
                 STRAGGLER_SIGNAL_DETECTIONS):
        self.miss_threshold = int(miss_threshold)
        self.straggler_cfg = straggler or StragglerConfig()
        self.straggler_signal_detections = int(straggler_signal_detections)
        self._lock = threading.Lock()
        #: cumulative missed-beat count across every node and epoch
        self.heartbeat_misses = 0
        #: test hook — fn(node) -> Optional[seconds] overriding measured
        #: read latency (deterministic straggler reproduction, no sleeps)
        self._latency_injector: Optional[Callable[[str],
                                                  Optional[float]]] = None
        self._pending: List[ClusterSignal] = []
        self._signalled: set = set()          # (kind, node) dedupe
        self.reset_nodes(nodes)

    # -- membership ----------------------------------------------------------
    def reset_nodes(self, nodes: Sequence[str]) -> None:
        """Adopt a new node set (called after a rebalance commits a new
        placement epoch).  Health state restarts: the new epoch's nodes
        all begin alive with fresh straggler windows."""
        with self._lock:
            self._nodes = tuple(str(n) for n in nodes)
            self._index = {n: i for i, n in enumerate(self._nodes)}
            self.coordinator = Coordinator(
                len(self._nodes), miss_threshold=self.miss_threshold)
            self.mitigator = StragglerMitigator(self.straggler_cfg)
            self._node_lat: Dict[str, Deque[float]] = {
                n: deque(maxlen=self.straggler_cfg.window)
                for n in self._nodes}
            self._node_detections: Dict[str, int] = dict.fromkeys(
                self._nodes, 0)
            self._step = 0
            self._signalled = {s for s in self._signalled
                               if s[1] in self._index}

    @property
    def nodes(self) -> Tuple[str, ...]:
        return self._nodes

    def node_index(self, node: str) -> int:
        return self._index[node]

    def node_name(self, index: int) -> str:
        return self._nodes[index]

    # -- heartbeats (fault_tolerance wiring) ---------------------------------
    def heartbeat(self, node: str, step: Optional[int] = None) -> None:
        """A node posts liveness for ``step`` (default: the current one)."""
        with self._lock:
            if node not in self._index:
                return
            self.coordinator.heartbeat(
                self._index[node], self._step if step is None else int(step))

    def tick(self, step: Optional[int] = None,
             checkpoint_step: int = 0) -> List[ClusterSignal]:
        """Advance failure detection one logical step.  Call ONCE per
        control-plane step — the Coordinator counts a missed beat per
        call for every stale node.  Returns the signals newly raised by
        this tick (they also queue for :meth:`signals`)."""
        new: List[ClusterSignal] = []
        with self._lock:
            self._step = self._step + 1 if step is None else int(step)
            before = {w: h.missed
                      for w, h in self.coordinator.workers.items()}
            ev: Optional[FailureEvent] = self.coordinator.tick(
                self._step, checkpoint_step)
            for w, h in self.coordinator.workers.items():
                if h.missed > before.get(w, 0):
                    self.heartbeat_misses += h.missed - before[w]
            # a worker that just crossed the threshold keeps its count
            # (alive=False freezes it); failures past the first within one
            # tick surface on subsequent ticks, one per call
            if ev is not None:
                node = self._nodes[ev.worker]
                sig = self._raise("node_lost", node, {
                    "missed": float(
                        self.coordinator.workers[ev.worker].missed),
                    "restart_step": float(ev.restart_step)})
                if sig is not None:
                    new.append(sig)
        return new

    def alive_nodes(self) -> List[str]:
        with self._lock:
            return [self._nodes[w] for w in self.coordinator.alive_workers()]

    def dead_nodes(self) -> List[str]:
        with self._lock:
            alive = set(self.coordinator.alive_workers())
            return [n for i, n in enumerate(self._nodes) if i not in alive]

    # -- read-path straggler detection (straggler wiring) --------------------
    def set_read_latency(self, fn: Optional[Callable[[str],
                                                     Optional[float]]]
                         ) -> None:
        """Install (or with ``None`` remove) a per-node latency injector
        for tests; injected values replace measured wall time."""
        self._latency_injector = fn

    def observed_latency(self, node: str, measured: float) -> float:
        fn = self._latency_injector
        if fn is not None:
            injected = fn(node)
            if injected is not None:
                return float(injected)
        return measured

    def record_read(self, node: str, latency: float) -> bool:
        """Feed one per-part segment read into the p50-window detector.
        Returns True when this read straggled (latency > factor × p50) —
        the store's cue to reissue against a replica holder.  A node
        accumulating ``straggler_signal_detections`` straggled reads
        raises a ``straggler`` signal for the Autopilot."""
        with self._lock:
            thr = self.mitigator.threshold()
            straggled = thr is not None and latency > thr
            if straggled:
                idx = self._index.get(node, -1)
                self.mitigator.detections.append((self._step, idx, latency))
                self.mitigator.reissues += 1
                self._node_detections[node] = \
                    self._node_detections.get(node, 0) + 1
                if (self._node_detections[node]
                        >= self.straggler_signal_detections):
                    self._raise("straggler", node, {
                        "latency_s": float(latency),
                        "threshold_s": float(thr),
                        "excess_s": float(latency - thr /
                                          self.straggler_cfg.factor),
                        "detections": float(self._node_detections[node])})
            self.mitigator.record(latency)
            lat = self._node_lat.get(node)
            if lat is not None:
                lat.append(latency)
            return straggled

    @property
    def straggler_reissues(self) -> int:
        return self.mitigator.reissues

    def straggler_excess_s(self, node: str) -> float:
        """How much slower than the cluster median this node's recent
        reads run (seconds per read; 0 when unknown)."""
        with self._lock:
            lat = self._node_lat.get(node)
            if not lat or len(self.mitigator.samples) == 0:
                return 0.0
            p50 = float(np.percentile(self.mitigator.samples, 50))
            return max(0.0, float(np.mean(lat)) - p50)

    # -- signal queue (Autopilot inlet) --------------------------------------
    def _raise(self, kind: str, node: str,
               detail: Dict[str, float]) -> Optional[ClusterSignal]:
        """Queue a signal once per (kind, node) until membership changes
        (reset_nodes clears handled entries) — lock held by caller."""
        key = (kind, node)
        if key in self._signalled:
            return None
        self._signalled.add(key)
        sig = ClusterSignal(kind=kind, node=node, step=self._step,
                            detail=dict(detail))
        self._pending.append(sig)
        return sig

    def signals(self) -> List[ClusterSignal]:
        """Drain pending signals (each delivered exactly once)."""
        with self._lock:
            out, self._pending = self._pending, []
            return out
