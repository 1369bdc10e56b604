"""Observer — the "observe" third of the Autopilot loop (DESIGN §8).

Attaches to run hooks — of a :class:`~repro_torch.api.Session` or the legacy
:class:`~repro_torch.core.engine.Engine` shim — and turns every execution into
durable signal: an :class:`~repro_torch.core.history.
ExecutionRecord` appended to the :class:`~repro_torch.core.history.HistoryStore`
(latency, input/output bytes, per-candidate selectivity/distinct-key stats
measured at each partition node), plus live shuffle-throughput samples fed
to the :class:`~repro_torch.service.cost_model.WhatIfCostModel` calibration.
The measurement pass at partition nodes only runs while an observer (or
any other hook/history) is attached; unobserved runs skip it.

Timestamps come from a pluggable clock.  Production uses ``time.time``;
tests and the drift scenarios use :class:`LogicalClock` so the recency
window of the cost model is deterministic under ``tick()``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..core.executor import EngineStats
from ..core.history import ExecutionRecord, HistoryStore


class LogicalClock:
    """Deterministic clock: each ``()`` call returns the next tick.

    ``peek()`` reads without advancing (the optimizer uses it so scoring a
    tick does not age the history it scores)."""

    def __init__(self, start: float = 0.0, step: float = 1.0):
        self._now = float(start)
        self.step = float(step)

    def __call__(self) -> float:
        self._now += self.step
        return self._now

    def peek(self) -> float:
        return self._now


class Observer:
    """Auto-appends an ExecutionRecord per observed Session/Engine run.

    ``attach(engine)`` registers a run hook; from then on every run of that
    engine is recorded with this observer's clock — no hand-built records.
    ``max_records`` (optional) auto-compacts the history so the log stays
    bounded under continuous service writes; compaction (a full-log merge
    + JSONL rewrite) only triggers once the log exceeds ``max_records``
    by ``compact_slack`` records, so steady state amortizes the rewrite
    over ~slack appends instead of paying it on every run.
    """

    def __init__(self, history: Optional[HistoryStore] = None, *,
                 clock: Callable[[], float] = time.time,
                 cost_model=None,
                 max_records: Optional[int] = None,
                 compact_slack: Optional[int] = None):
        self.history = history if history is not None else HistoryStore()
        self.clock = clock
        self.cost_model = cost_model
        self.max_records = max_records
        if compact_slack is None and max_records is not None:
            compact_slack = max(8, max_records // 2)
        self.compact_slack = compact_slack
        self.records_seen = 0
        self.compacted_total = 0

    def attach(self, session) -> "Observer":
        """Register on anything with ``add_run_hook`` (Session or the
        legacy Engine shim)."""
        session.add_run_hook(self.on_run)
        return self

    # -- the hook -----------------------------------------------------------
    def on_run(self, workload, stats: EngineStats) -> ExecutionRecord:
        # per-run dedupe: when THIS run's executor already appended its
        # record to this exact HistoryStore (session/engine constructed
        # with history=..., or run(history=...) passed explicitly), adopt
        # that record instead of logging a duplicate — double records
        # would double the run rates the cost model prices from
        if stats.history_logged is self.history and self.history.records:
            rec = self.history.records[-1]      # the executor's append
        else:
            rec = self.history.log_workload(
                workload, timestamp=self.clock(), latency=stats.wall_s,
                input_bytes=float(stats.input_bytes),
                output_bytes=float(stats.output_bytes),
                padded_bytes=float(stats.padded_bytes),
                valid_bytes=float(stats.valid_bytes),
                candidate_stats=dict(stats.candidate_stats or {}))
        self.records_seen += 1
        if self.cost_model is not None and stats.shuffle_bytes \
                and stats.shuffle_s > 0:
            self.cost_model.observe_shuffle(stats.shuffle_bytes,
                                            stats.shuffle_s)
        # durable-tier calibration (DESIGN §10): live segment I/O this run
        # caused (autoflushed writes, spill rehydration) prices the cost
        # model's spill/load charges
        if self.cost_model is not None and stats.storage_io_bytes \
                and stats.storage_io_s > 0:
            self.cost_model.observe_io(stats.storage_io_bytes,
                                       stats.storage_io_s)
        if self.max_records is not None and len(self.history.records) \
                >= self.max_records + self.compact_slack:
            self.compacted_total += self.history.compact(self.max_records)
        return rec
