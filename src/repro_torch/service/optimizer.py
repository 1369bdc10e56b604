"""The Autopilot optimizer loop — "decide + apply" (DESIGN §8).

:class:`StorageOptimizer` closes the paper's loop online: per ``tick()`` it
walks every stored dataset, enumerates candidate layouts from the observed
history (Alg. 1+2 over each consumer IR in the skeleton graph), lets a
selector policy — greedy Eq. 2 or the DRL agent, both behind the same
``select(feats, groups, dataset_bytes, state)`` interface — pick the
preferred layout, prices it with the :class:`~repro_torch.service.cost_model.
WhatIfCostModel`, and when the modeled benefit clears the hysteresis
threshold applies the :class:`~repro_torch.core.advisor.PartitioningDecision`
through ``PartitionStore.repartition(swap=True)`` — the device-to-device
fast path when the store is device-backed — publishing a new generation
with one atomic pointer flip.

``tick()`` is the deterministic unit (tests, drift scenarios drive it
directly); ``start(period_s)`` runs the same tick on a daemon thread for a
live service.  Flip-flop guards: the hysteresis factor, a per-dataset
cooldown after each applied decision, and a minimum observed-run count.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.advisor import (GreedySelector, PartitioningDecision,
                            apply_decision)
from ..obs.tracer import TRACER as _TRACER, span as _span
from ..core.features import build_state, candidate_features
from ..core.history import HistoryStore
from ..core.partitioner import (SaltedPartitioner, dedupe,
                                enumerate_candidates)
from ..data.capacity import plan_capacity_map
from ..data.skew import HeavyHitterSketch
from .cost_model import LayoutScore, WhatIfCostModel
from .observer import Observer

#: in-memory why-record ring bound — enough to audit a long soak without
#: letting a permanently-attached autopilot grow without bound
WHY_RECORDS_CAP = 512


@dataclass
class AutopilotConfig:
    hysteresis: float = 1.5        # benefit must exceed cost × this factor
    window_s: float = float("inf")  # recency window for run-rate estimation
    horizon_windows: float = 4.0   # future windows a layout keeps paying off
    min_runs: float = 2.0          # observed runs before acting on a dataset
    cooldown_ticks: int = 1        # ticks to skip a dataset after a swap
    max_candidates: int = 12       # state-vector rows (advisor action space)
    max_history_records: Optional[int] = None   # auto-compact bound
    datasets: Optional[Tuple[str, ...]] = None  # allowlist (None = all)
    # -- skew actions (DESIGN §12) -------------------------------------------
    # None → follow the store (on iff store.adaptive_capacity); True/False
    # force.  Salting triggers when the dataset's fill skew reaches
    # skew_threshold AND the observed hottest-key share (heavy-hitter
    # sketch in the candidate stats) reaches hot_key_fraction.
    skew_actions: Optional[bool] = None
    hot_key_fraction: float = 0.25
    skew_threshold: float = 2.0
    salt_factor: int = 4
    # hottest-key share below which a salted layout is unwound (the split
    # stops paying for its lost elisions once the key cools).  None →
    # hot_key_fraction / 2: a deliberate gap between the salt and unsalt
    # thresholds so a key oscillating around hot_key_fraction never
    # flip-flops the layout.
    unsalt_hot_key_fraction: Optional[float] = None
    # -- cluster actions (DESIGN §14) ----------------------------------------
    # None → follow the store (on iff the store is cluster-backed);
    # True/False force.  When on, the tick drains the store's
    # ClusterHealth signals (lost nodes, stragglers) and answers each with
    # a priced rebalance decision.
    cluster_actions: Optional[bool] = None


@dataclass
class AppliedDecision:
    """One autonomous layout action: the advisor decision (None for a
    rebucket — no candidate changes), its what-if score, and what actually
    happened when it was applied."""
    dataset: str                   # "*" for a store-wide rebalance
    decision: Optional[PartitioningDecision]
    score: LayoutScore
    generation: int                # generation published by the swap
                                   # (directory epoch for a rebalance)
    moved_bytes: int
    repartition_wall_s: float
    path: str                      # "d2d" | "host" | "rebucket" | "rebalance"
    kind: str = "repartition"      # "repartition" | "salt" | "unsalt" |
                                   # "rebucket" | "rebalance"


@dataclass
class TickReport:
    tick: int
    now: float
    considered: List[Tuple[str, str, LayoutScore]] = field(
        default_factory=list)      # (dataset, candidate sig, score)
    applied: List[AppliedDecision] = field(default_factory=list)
    compacted: int = 0
    why: List[Dict[str, Any]] = field(default_factory=list)


class StorageOptimizer:
    """The decide→apply loop over one store + one history."""

    def __init__(self, store, history: HistoryStore, *,
                 cost_model: Optional[WhatIfCostModel] = None,
                 selector=None,
                 config: Optional[AutopilotConfig] = None,
                 mesh=None,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.history = history
        self.cost_model = cost_model or WhatIfCostModel()
        self.selector = selector or GreedySelector()
        self.cfg = config or AutopilotConfig()
        self.mesh = mesh
        self.clock = clock
        self.reports: List[TickReport] = []
        self.why_records: List[Dict[str, Any]] = []
        self._cooldown: Dict[str, int] = {}
        self._tick_no = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_error: Optional[BaseException] = None

    # -- candidate enumeration over the observed consumer IRs ----------------
    def _enumerate(self, dataset: str, groups):
        cands, cand_groups, rel_groups = [], {}, []
        for sig in sorted(groups):
            ir = self.history.ir_of(sig)
            if ir is None or ir.find_scanner(dataset) is None:
                continue
            rel_groups.append(groups[sig])
            for c in enumerate_candidates(ir, dataset):
                cands.append(c)
                cand_groups.setdefault(c.signature(), []).append(groups[sig])
        return dedupe(cands), cand_groups, rel_groups

    # -- skew actions: hot-key salting + capacity rebucketing (DESIGN §12) ---
    def _skew_enabled(self) -> bool:
        if self.cfg.skew_actions is not None:
            return bool(self.cfg.skew_actions)
        return bool(getattr(self.store, "adaptive_capacity", False))

    # -- cluster actions: health signals → rebalance decisions (DESIGN §14) --
    def _cluster_enabled(self) -> bool:
        if self.cfg.cluster_actions is not None:
            return bool(self.cfg.cluster_actions)
        return bool(getattr(self.store, "is_cluster", False))

    def _window_run_rate(self, now: float) -> float:
        """Weight-aware observed runs inside the recency window, across
        every consumer — the rate a store-wide degradation is paid at."""
        return sum(r.weight for r in self.history.records
                   if r.timestamp >= now - self.cfg.window_s)

    def _consider_cluster(self, now: float, report: TickReport):
        """Drain the store's ClusterHealth signals and answer each with a
        priced rebalance consideration.  At most one rebalance queues per
        tick (applying one bumps the placement epoch, which would stale
        any plan built alongside it); every signal still gets its own
        why-record.  Returns the queued ``("rebalance", "*", plan,
        score)`` or None."""
        health = getattr(self.store, "health", None)
        if health is None:
            return None
        queued = None
        for sig in health.signals():
            directory = self.store.directory
            node, nodes = sig.node, directory.nodes
            survivors = [n for n in nodes if n != node]
            candidate = f"remove:{node}"
            gates = [
                self._gate("node_in_membership", node in nodes, node=node),
                self._gate("surviving_nodes", len(survivors) >= 1,
                           observed=len(survivors), required=1),
                self._gate("single_rebalance_per_tick", queued is None),
            ]
            if not all(g["passed"] for g in gates):
                self._why(report, "*", f"rebalance:{sig.kind}", candidate,
                          None, gates, False)
                continue
            plan = self.store.plan_rebalance(
                remove_nodes=(node,), reason=f"{sig.kind}:{node}")
            cost_s = self.cost_model.rebalance_seconds(plan.est_bytes_moved)
            runs = self._window_run_rate(now)
            if sig.kind == "node_lost":
                # until the displaced partitions re-home, every run reads
                # them degraded off replicas and the store sits one more
                # failure from data loss — each windowed run is priced as
                # re-paying the displaced bytes' transfer
                benefit_s = max(runs, 1.0) * cost_s
            else:   # straggler: runs keep paying the node's excess latency
                benefit_s = runs * float(sig.detail.get("excess_s", 0.0))
            score = LayoutScore(
                dataset="*", candidate_signature=candidate,
                benefit_s=benefit_s, repartition_s=0.0,
                runs_in_window=runs, shuffles_delta=0.0, io_s=cost_s)
            report.considered.append(("*", candidate, score))
            gates.append(self._gate(
                "mesh_replan", not plan.mesh_error,
                error=plan.mesh_error,
                mesh=str(plan.mesh.shape) if plan.mesh else ""))
            if sig.kind == "node_lost":
                # replication must be restored — a lost node is priced for
                # the record but never benefit-gated
                gates.append(self._gate("replication_at_risk", True,
                                        missed=sig.detail.get("missed", 0.0)))
            else:
                gates.append(self._gate(
                    "worth_it", score.worth_it(self.cfg.hysteresis,
                                               self.cfg.horizon_windows)))
            accepted = all(g["passed"] for g in gates)
            self._why(report, "*", f"rebalance:{sig.kind}", candidate, score,
                      gates, accepted)
            if accepted:
                queued = ("rebalance", "*", plan, score)
        return queued

    def _apply_rebalance(self, plan, score: LayoutScore, report: TickReport,
                         now: float) -> None:
        """Apply a queued rebalance plan: stream the minimal move set and
        commit the new placement epoch (one atomic pointer flip per
        dataset, then the EPOCH pointer)."""
        with _span("autopilot.apply", "autopilot", dataset="*",
                   kind="rebalance") as asp:
            try:
                res = self.store.rebalance(plan=plan)
            except ValueError as e:    # plan went stale under our feet
                asp.set(skipped=str(e))
                return
            streamed = res.bytes_moved + res.replica_bytes
            if streamed > 0 and res.wall_s > 0:
                self.cost_model.observe_io(streamed, res.wall_s)
            applied = AppliedDecision(
                dataset="*", decision=None, score=score,
                generation=res.epoch, moved_bytes=res.bytes_moved,
                repartition_wall_s=res.wall_s, path="rebalance",
                kind="rebalance")
            asp.set(epoch=res.epoch, moved_bytes=int(res.bytes_moved),
                    partitions_moved=int(res.partitions_moved),
                    bytes_linked=int(res.bytes_linked))
            report.applied.append(applied)
            self._catalog_log(applied, now)

    # -- decision explainability (DESIGN §13) --------------------------------
    @staticmethod
    def _gate(name: str, passed: bool, **detail) -> Dict[str, Any]:
        g: Dict[str, Any] = {"gate": name, "passed": bool(passed)}
        for k, v in detail.items():
            g[k] = float(v) if isinstance(v, (int, float)) else v
        return g

    def _why(self, report: TickReport, dataset: str, action: str,
             candidate: str, score: Optional[LayoutScore],
             gates: List[Dict[str, Any]], accepted: bool) -> None:
        """One structured why-record: the candidate's priced score (full
        gate math) plus every gate's verdict, whether it accepted or
        rejected the candidate.  Records accumulate on the tick's report;
        :meth:`tick` batches them into ``decisions.log`` and the bounded
        in-memory ring behind :meth:`explain`."""
        report.why.append({
            "kind": "why", "tick": self._tick_no, "now": float(report.now),
            "dataset": dataset, "action": action, "candidate": candidate,
            "accepted": bool(accepted),
            "score": (score.explain(self.cfg.hysteresis,
                                    self.cfg.horizon_windows)
                      if score is not None else None),
            "gates": gates,
        })

    def explain(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Recent why-records (oldest first, bounded in memory at
        :data:`WHY_RECORDS_CAP`)."""
        recs = list(self.why_records)
        return recs[-limit:] if limit else recs

    def _observed_hot_fraction(self, cands, now: float) -> float:
        """Largest heavy-hitter share the Observer's per-candidate stats
        pass measured for any of this dataset's candidates inside the
        recency window — a lower bound (Misra-Gries), so acting on it
        never over-triggers a split."""
        sigs = {c.signature() for c in cands}
        best = 0.0
        for rec in self.history.records:
            if rec.timestamp < now - self.cfg.window_s:
                continue
            for sig, st in rec.candidate_stats.items():
                if sig in sigs:
                    best = max(best, float(st.get("max_key_fraction", 0.0)))
        return best

    def _consider_skew(self, name: str, ds, cands, groups, now: float,
                       report: TickReport):
        """Price the two skew actions for one dataset; return a queued
        ``(kind, name, decision, score)`` or None.  Salting is tried first
        (it changes which rows go where, fixing the imbalance at the
        source); rebucketing is the fallback that keeps the partitioner
        and only re-shapes per-partition capacity."""
        cur_sig = ds.partitioner.signature() if ds.partitioner else ""
        # -- hot-key splitting ------------------------------------------------
        base = next((c for c in cands if c.is_keyed and c.graph is not None),
                    None)
        if base is not None and "salt" not in cur_sig:
            skew = float(ds.skew())
            hot = self._observed_hot_fraction(cands, now)
            gates = [
                self._gate("skew_threshold",
                           skew >= self.cfg.skew_threshold,
                           observed=skew, required=self.cfg.skew_threshold),
                self._gate("hot_key_fraction",
                           hot >= self.cfg.hot_key_fraction,
                           observed=hot, required=self.cfg.hot_key_fraction),
            ]
            if not all(g["passed"] for g in gates):
                self._why(report, name, "salt", "", None, gates, False)
            else:
                # score with an empty-keyed preview: a salted signature
                # never matches Alg. 4, so its elision count (0) prices the
                # benefit the split gives up, against the padding bytes it
                # wins back
                preview = SaltedPartitioner(
                    graph=base.graph, strategy=base.strategy,
                    source_dataset=base.source_dataset, origin=base.origin,
                    hot_keys=(), salt_factor=self.cfg.salt_factor)
                score = self.cost_model.score(
                    name, float(ds.nbytes), ds.num_workers, preview,
                    ds.partitioner, self.history, now=now,
                    window_s=self.cfg.window_s, groups=groups,
                    durable=self.store.is_durable and self.store.autoflush,
                    source_spilled=self.store.is_durable
                    and self.store.is_spilled(name),
                    current_padded_bytes=float(ds.padded_bytes),
                    current_valid_bytes=float(ds.valid_bytes),
                    # salted counts are near-balanced; power-of-two rounding
                    # bounds the residual padding at 2×, 1.25× is the
                    # midpoint
                    candidate_padded_bytes=1.25 * float(ds.valid_bytes))
                report.considered.append((name, preview.signature(), score))
                gates.append(self._gate(
                    "min_runs", score.runs_in_window >= self.cfg.min_runs,
                    observed=score.runs_in_window,
                    required=self.cfg.min_runs))
                gates.append(self._gate(
                    "worth_it", score.worth_it(self.cfg.hysteresis,
                                               self.cfg.horizon_windows)))
                accepted = all(g["passed"] for g in gates)
                self._why(report, name, "salt", preview.signature(), score,
                          gates, accepted)
                if accepted:
                    decision = PartitioningDecision(
                        dataset=name, candidate=base, features=[],
                        consumers=[], action_index=-1, state=None,
                        elapsed_s=0.0)
                    return ("salt", name, decision, score)
        # -- hot-key cooling: unwind a salted layout --------------------------
        elif base is not None and "salt" in cur_sig:
            hot = self._observed_hot_fraction(cands, now)
            unsalt_thr = (self.cfg.unsalt_hot_key_fraction
                          if self.cfg.unsalt_hot_key_fraction is not None
                          else self.cfg.hot_key_fraction / 2.0)
            gates = [self._gate("hot_key_cooled", hot < unsalt_thr,
                                observed=hot, required=unsalt_thr)]
            if not all(g["passed"] for g in gates):
                self._why(report, name, "unsalt", "", None, gates, False)
            else:
                # the cooled key no longer needs the split; the plain keyed
                # layout matches Alg. 4 again, so its restored elisions are
                # the benefit side — no padding term (a cooled key fills
                # partitions evenly under either layout)
                score = self.cost_model.score(
                    name, float(ds.nbytes), ds.num_workers, base,
                    ds.partitioner, self.history, now=now,
                    window_s=self.cfg.window_s, groups=groups,
                    durable=self.store.is_durable and self.store.autoflush,
                    source_spilled=self.store.is_durable
                    and self.store.is_spilled(name))
                report.considered.append((name, base.signature(), score))
                gates.append(self._gate(
                    "min_runs", score.runs_in_window >= self.cfg.min_runs,
                    observed=score.runs_in_window,
                    required=self.cfg.min_runs))
                gates.append(self._gate(
                    "worth_it", score.worth_it(self.cfg.hysteresis,
                                               self.cfg.horizon_windows)))
                accepted = all(g["passed"] for g in gates)
                self._why(report, name, "unsalt", base.signature(), score,
                          gates, accepted)
                if accepted:
                    decision = PartitioningDecision(
                        dataset=name, candidate=base, features=[],
                        consumers=[], action_index=-1, state=None,
                        elapsed_s=0.0)
                    return ("unsalt", name, decision, score)
        # -- capacity rebucketing ---------------------------------------------
        if ds.partitioner is None:
            return None
        cmap = plan_capacity_map(
            ds.counts, threshold=getattr(self.store, "capacity_threshold",
                                         0.75))
        if cmap == ds.capacity_map or \
                (cmap is None and ds.capacity_map is None):
            return None
        slots = max(ds.total_slots, 1)
        per_slot = float(ds.padded_bytes) / slots
        new_slots = (cmap.total_slots if cmap is not None
                     else ds.num_workers * int(ds.counts.max()))
        score = self.cost_model.score(
            name, float(ds.nbytes), ds.num_workers, ds.partitioner,
            ds.partitioner, self.history, now=now,
            window_s=self.cfg.window_s, groups=groups,
            durable=self.store.is_durable and self.store.autoflush,
            source_spilled=False,   # rebucket reads the live generation
            current_padded_bytes=float(ds.padded_bytes),
            current_valid_bytes=float(ds.valid_bytes),
            candidate_padded_bytes=per_slot * new_slots,
            local=True)             # same partitioner: node-local rewrite
        report.considered.append((name, "rebucket", score))
        gates = [
            self._gate("min_runs",
                       score.runs_in_window >= self.cfg.min_runs,
                       observed=score.runs_in_window,
                       required=self.cfg.min_runs),
            self._gate("worth_it", score.worth_it(self.cfg.hysteresis,
                                                  self.cfg.horizon_windows)),
        ]
        accepted = all(g["passed"] for g in gates)
        self._why(report, name, "rebucket", "rebucket", score, gates,
                  accepted)
        if accepted:
            return ("rebucket", name, None, score)
        return None

    def _make_salted(self, name: str, base) -> Optional[SaltedPartitioner]:
        """Materialize the salt decision at apply time: sketch the live key
        column for its heavy hitters (the tick gate used the Observer's
        windowed stats; the actual keys may have drifted since)."""
        ds = self.store.read(name)
        keys = np.asarray(base.key_fn()(ds.gather())).reshape(-1)
        sk = HeavyHitterSketch(k=8).update(keys)
        hot = tuple(sorted(k for k, _ in
                           sk.heavy_hitters(self.cfg.hot_key_fraction)))
        if not hot:
            return None
        return SaltedPartitioner(
            graph=base.graph, strategy=base.strategy,
            source_dataset=base.source_dataset, origin=base.origin,
            hot_keys=hot, salt_factor=self.cfg.salt_factor)

    # -- one deterministic pass over the store -------------------------------
    def tick(self) -> TickReport:
        """Score every dataset against one calibration snapshot, then apply
        the decisions that cleared the gates (two-phase, so the order the
        store iterates in never skews a later dataset's pricing).

        The clock is read without advancing when it supports ``peek()``
        (LogicalClock): scoring a tick must not age the history it scores,
        or idle polling alone would push observed runs out of the recency
        window."""
        with _span("autopilot.tick", "autopilot") as tsp:
            return self._tick(tsp)

    def _tick(self, tsp) -> TickReport:
        peek = getattr(self.clock, "peek", None)
        now = peek() if peek is not None else self.clock()
        self._tick_no += 1
        report = TickReport(tick=self._tick_no, now=now)
        # (kind, dataset, decision-or-None, score)
        to_apply: List[Tuple[str, str,
                             Optional[PartitioningDecision], LayoutScore]] = []
        # one O(records²) skeleton build per tick, shared by every dataset's
        # enumeration and what-if score
        groups, _ = self.history.skeleton_graph()
        # watchdog phase (DESIGN §15): regression alerts from the durable
        # telemetry become explained why-records through the same path
        # ClusterHealth signals take
        self._consider_watchdog(report)
        # cluster phase first: a queued rebalance applies before any
        # per-dataset swap, so those swaps persist against the new placement
        if self._cluster_enabled():
            cluster = self._consider_cluster(now, report)
            if cluster is not None:
                to_apply.append(cluster)
        for name in sorted(self.store.datasets):
            if self.cfg.datasets is not None and name not in self.cfg.datasets:
                continue
            if self._cooldown.get(name, 0) > 0:
                self._cooldown[name] -= 1
                continue
            ds = self.store.read(name)
            cands, cand_groups, rel_groups = self._enumerate(name, groups)
            queued = False
            # a salted dataset under active skew management is owned by the
            # skew phase: unwinding the split must clear the hot_key_cooled
            # gate, or the generic phase would flip a still-hot key straight
            # back to the keyed layout it just split away from
            salted_now = ds.partitioner is not None and \
                "salt" in ds.partitioner.signature()
            if cands and not (salted_now and self._skew_enabled()):
                # policy pick (greedy Eq. 2 / DRL — one interface)
                t0 = time.perf_counter()
                feats = [candidate_features(c,
                                            cand_groups.get(c.signature(), []),
                                            self.history, now)
                         for c in cands]
                state = build_state(feats, float(ds.nbytes),
                                    self.cfg.max_candidates, now=now)
                idx = self.selector.select(feats, rel_groups,
                                           float(ds.nbytes), state)
                idx = max(0, min(int(idx), len(feats) - 1))
                cand = feats[idx].candidate
                decision = PartitioningDecision(
                    dataset=name, candidate=cand, features=feats,
                    consumers=[g.ir_signature for g in rel_groups],
                    action_index=idx, state=state,
                    elapsed_s=time.perf_counter() - t0)

                # what-if gate against the live layout; a durable store also
                # pays segment I/O (persist the new generation, rehydrate a
                # spilled source) — priced by the calibrated io throughput
                score = self.cost_model.score(
                    name, float(ds.nbytes), ds.num_workers, cand,
                    ds.partitioner, self.history, now=now,
                    window_s=self.cfg.window_s, groups=groups,
                    # only charge the persist when applying will actually
                    # pay it (autoflush); batched stores defer that cost
                    durable=self.store.is_durable and self.store.autoflush,
                    source_spilled=self.store.is_durable
                    and self.store.is_spilled(name))
                report.considered.append((name, cand.signature(), score))
                same = (ds.partitioner is not None and
                        ds.partitioner.signature() == cand.signature())
                gates = [
                    self._gate("not_current_layout", not same,
                               current=(ds.partitioner.signature()
                                        if ds.partitioner else "")),
                    self._gate("min_runs",
                               score.runs_in_window >= self.cfg.min_runs,
                               observed=score.runs_in_window,
                               required=self.cfg.min_runs),
                    self._gate("worth_it",
                               score.worth_it(self.cfg.hysteresis,
                                              self.cfg.horizon_windows)),
                ]
                accepted = all(g["passed"] for g in gates)
                self._why(report, name, "repartition", cand.signature(),
                          score, gates, accepted)
                if accepted:
                    to_apply.append(("repartition", name, decision, score))
                    queued = True
            # skew phase (DESIGN §12): when no layout change was queued,
            # consider hot-key salting and capacity rebucketing — actions
            # that fix padding waste rather than elide shuffles
            if not queued and self._skew_enabled():
                skew = self._consider_skew(name, ds, cands, groups, now,
                                           report)
                if skew is not None:
                    to_apply.append(skew)

        if report.why:
            # one bounded in-memory ring + one JSONL row per tick (the
            # records ride together so a busy tick costs one fsync).
            # Logged BEFORE the applies so the catalog reads
            # considered-then-applied and the newest row stays the latest
            # applied decision, as pre-§13 consumers of decisions() expect.
            self.why_records.extend(report.why)
            del self.why_records[:-WHY_RECORDS_CAP]
            if self.store.durable is not None:
                self.store.durable.log_decision({
                    "kind": "why", "tick": self._tick_no,
                    "now": float(now), "count": len(report.why),
                    "records": report.why})

        for kind, name, decision, score in to_apply:
            if kind == "rebalance":   # store-wide: no single dataset to read
                self._apply_rebalance(decision, score, report, now)
                continue
            # apply: materialize off to the side, atomically flip (swap)
            with _span("autopilot.apply", "autopilot", dataset=name,
                       kind=kind) as asp:
                ds_bytes = float(self.store.read(name).nbytes)
                io0 = self.store.io_snapshot()
                t1 = time.perf_counter()
                if kind in ("repartition", "unsalt"):
                    new, moved = apply_decision(self.store, decision,
                                                mesh=self.mesh)
                elif kind == "salt":
                    salted = self._make_salted(name, decision.candidate)
                    if salted is None:
                        asp.set(skipped="no_hot_key_at_apply")
                        continue   # sketch found no hot key at apply time
                    decision = PartitioningDecision(
                        dataset=name, candidate=salted,
                        features=decision.features,
                        consumers=decision.consumers, action_index=-1,
                        state=decision.state, elapsed_s=decision.elapsed_s)
                    new, moved = self.store.repartition(
                        self.store.read(name), salted, mesh=self.mesh,
                        swap=True)
                else:   # rebucket: same partitioner, node-local re-layout
                    new, moved = self.store.rebucket(name)
                # the d2d repartition and the rebucket synchronize inside
                # the store; the salt's host-pid write does not, so the
                # wall that calibrates repartition throughput waits here
                # for every kind's device work
                self.store.synchronize()
                wall = time.perf_counter() - t1
                # the wall includes any autoflush persist; attribute that
                # slice to the io calibration and only the remainder to the
                # shuffle, so score()'s repartition_s + io_s never
                # double-charges
                io_wall = self._feed_io_calibration(io0)
                if kind != "rebucket":   # rebucket moves 0 bytes — no sample
                    self.cost_model.observe_repartition(
                        ds_bytes, max(wall - io_wall, 0.0))
                self._cooldown[name] = self.cfg.cooldown_ticks
                path = "host"
                if self.store.write_log and \
                        self.store.write_log[-1].get("name") == name:
                    path = self.store.write_log[-1].get("path", "host")
                applied = AppliedDecision(
                    dataset=name, decision=decision, score=score,
                    generation=new.generation, moved_bytes=moved,
                    repartition_wall_s=wall, path=path, kind=kind)
                asp.set(generation=new.generation, moved_bytes=int(moved),
                        path=path)
                report.applied.append(applied)
                self._catalog_log(applied, now)
        if self.cfg.max_history_records is not None:
            report.compacted = self.history.compact(
                self.cfg.max_history_records)
        self._record_tick_telemetry(report, now)
        self.reports.append(report)
        tsp.set(tick=self._tick_no, considered=len(report.considered),
                applied=len(report.applied))
        return report

    def _consider_watchdog(self, report: TickReport) -> None:
        """Run the telemetry regression watchdog (DESIGN §15) and turn
        each deduped ``perf_regression`` signal into an explained
        why-record.  Alerts are observations, not actions — nothing
        queues for apply, but every alert leaves an audit trail in
        ``decisions.log`` with the observed/baseline/tolerance math."""
        wd = getattr(self.store, "watchdog", None)
        if wd is None:
            return
        try:
            wd.check(step=self._tick_no)
            sigs = wd.signals()
        except Exception:   # noqa: BLE001 — the watchdog must never take
            return          # down the optimizer loop it watches
        for sig in sigs:
            det = dict(sig.detail)
            gates = [self._gate(
                "tolerance_exceeded", True,
                series=str(det.get("series", sig.node)),
                observed=det.get("observed", 0.0),
                baseline=det.get("baseline", 0.0),
                ratio=det.get("ratio", 0.0),
                tolerance=det.get("tolerance", 0.0))]
            self._why(report, "*", f"watchdog:{sig.kind}", sig.node,
                      None, gates, True)

    def _record_tick_telemetry(self, report: TickReport,
                               now: float) -> None:
        """Append one per-tick snapshot to the durable telemetry so the
        decision cadence survives next to the run profiles it acted on."""
        tele = getattr(self.store, "telemetry", None)
        if tele is None:
            return
        try:
            tele.record_tick({
                "tick": self._tick_no, "now": float(now),
                "considered": len(report.considered),
                "applied": [{"dataset": a.dataset, "kind": a.kind,
                             "generation": int(a.generation),
                             "moved_bytes": int(a.moved_bytes)}
                            for a in report.applied],
                "why_count": len(report.why)})
        except OSError:      # advisory — never fail the tick
            pass

    # -- durable-store integration (DESIGN §10) ------------------------------
    def _feed_io_calibration(self, io_before) -> float:
        """Turn the segment I/O an applied decision just caused (persist of
        the swapped generation, rehydration of a spilled source) into an
        io-throughput sample for the what-if model.  Returns the I/O wall
        seconds so the caller can subtract them from the shuffle sample."""
        if not io_before:
            return 0.0
        io1 = self.store.io_snapshot()
        d_bytes = (io1["bytes_written"] - io_before["bytes_written"]
                   + io1["bytes_read"] - io_before["bytes_read"])
        d_s = (io1["write_s"] - io_before["write_s"]
               + io1["read_s"] - io_before["read_s"])
        if d_bytes > 0 and d_s > 0:
            self.cost_model.observe_io(d_bytes, d_s)
        return max(float(d_s), 0.0)

    def _catalog_log(self, applied: AppliedDecision, now: float) -> None:
        """Record an applied decision in the durable store's catalog
        (``decisions.log``), so a later process reopening the store can
        audit why its layouts look the way they do.  No-op when the store
        is memory-only."""
        if self.store.durable is None:
            return
        s = applied.score
        self.store.durable.log_decision({
            "tick": self._tick_no, "now": float(now),
            "dataset": applied.dataset,
            "kind": applied.kind,
            "candidate": (applied.decision.candidate.signature()
                          if applied.decision is not None else ""),
            "generation": applied.generation,
            "moved_bytes": int(applied.moved_bytes),
            "repartition_wall_s": float(applied.repartition_wall_s),
            "path": applied.path,
            "benefit_s": float(s.benefit_s),
            "repartition_s": float(s.repartition_s),
            "io_s": float(s.io_s),
            "runs_in_window": float(s.runs_in_window),
            "shuffles_delta": float(s.shuffles_delta),
        })

    # -- background service mode ---------------------------------------------
    def start(self, period_s: float = 1.0) -> None:
        """Run ``tick()`` on a daemon thread every ``period_s`` until
        :meth:`stop`.  Exceptions land in ``last_error`` (and stop the
        loop) rather than killing the host process."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("optimizer already running")
        self._stop.clear()
        # capture the starting thread's span context so background ticks
        # parent (via a flow arrow) to whatever started the service
        ctx = _TRACER.context()

        def _loop():
            with _TRACER.attach(ctx):
                while not self._stop.wait(period_s):
                    try:
                        self.tick()
                    except BaseException as e:  # noqa: BLE001 — report & halt
                        self.last_error = e
                        return

        self._thread = threading.Thread(
            target=_loop, name="lachesis-autopilot", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


class Autopilot:
    """Facade wiring the whole subsystem to one execution surface:
    Observer (history + throughput calibration) + WhatIfCostModel +
    StorageOptimizer.

    Attaches to anything exposing ``.store`` and ``.add_run_hook`` — a
    :class:`~repro_torch.api.Session` (``session.autopilot()`` is the idiomatic
    spelling) or the legacy Engine shim::

        sess = Session(store)
        ap = sess.autopilot(clock=LogicalClock())
        sess.run(workload)         # observed automatically
        ap.tick()                  # decide + apply + swap generations

    Every applied decision publishes a new layout generation, which by
    construction invalidates exactly the cached PhysicalPlans that scan
    the repartitioned dataset (their cache key pins the generation) — the
    session re-plans on its next run and picks up the elisions.

    ``mesh`` (a ``core.sharding_bridge.Mesh`` of any number of devices)
    places every repartition the Autopilot applies on it; a dataset
    already placed there is repartitioned shard to shard.
    """

    def __init__(self, session, *, clock: Optional[Callable[[], float]] = None,
                 config: Optional[AutopilotConfig] = None,
                 selector=None, history: Optional[HistoryStore] = None,
                 bench_path: Optional[str] = None, mesh=None):
        clock = clock or time.time
        self.history = history if history is not None else HistoryStore()
        self.cost_model = WhatIfCostModel(bench_path=bench_path)
        self.observer = Observer(
            self.history, clock=clock, cost_model=self.cost_model,
            max_records=(config.max_history_records if config else None))
        self.observer.attach(session)
        self.optimizer = StorageOptimizer(
            session.store, self.history, cost_model=self.cost_model,
            selector=selector, config=config, mesh=mesh, clock=clock)
        self.session = session
        self.engine = session          # pre-split alias

    def tick(self) -> TickReport:
        return self.optimizer.tick()

    def explain(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Structured why-records for recent ticks (see
        :meth:`StorageOptimizer.explain`); the surface
        ``session.explain_decisions()`` reads."""
        return self.optimizer.explain(limit)

    def start(self, period_s: float = 1.0) -> None:
        self.optimizer.start(period_s)

    def stop(self, timeout: float = 10.0) -> None:
        self.optimizer.stop(timeout)
