"""Drift scenarios for the Autopilot service (DESIGN §8).

A deterministic end-to-end exercise of observe → decide → repartition:
TPC-H-like tables start round-robin; an orderkey-join mix (Q04 family)
runs until the optimizer autonomously partitions lineitem/orders by
orderkey and the joins stop shuffling; then the mix *drifts* to a
partkey-join (Q17 family) and the service re-partitions lineitem again —
away from the now-stale orderkey layout — all through ``tick()`` with a
:class:`~repro_torch.service.observer.LogicalClock`, so tests, the example and
the benchmark replay the exact same sequence.

Payload columns are integer-valued floats: keyed sums of exactly
representable integers are order-independent, so query results across
layout generations compare **bit-for-bit** even though row order inside
worker segments changes with the layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..api import Session
from ..core.dsl import Workload
from ..core.executor import EngineStats
from ..data.partition_store import PartitionStore
from ..data.skew import zipf_keys
from .observer import LogicalClock
from .optimizer import Autopilot, AutopilotConfig, TickReport


# -- workload mix ------------------------------------------------------------

def q_orderkey() -> Workload:
    """Q04-family: join lineitem with orders on orderkey, aggregate."""
    wl = Workload("q-orderkey")
    li = wl.scan("lineitem")
    od = wl.scan("orders")
    j = wl.join(li, od, left_key=li["orderkey"], right_key=od["orderkey"],
                tag="li_orders")
    agg = wl.aggregate(j, key=j["odate"], reducer="sum")
    wl.write(agg, "q_orderkey_out")
    return wl


def q_partkey() -> Workload:
    """Q17-family: join lineitem with part on partkey, aggregate."""
    wl = Workload("q-partkey")
    li = wl.scan("lineitem")
    pt = wl.scan("part")
    j = wl.join(li, pt, left_key=li["partkey"], right_key=pt["partkey"],
                tag="li_part")
    agg = wl.aggregate(j, key=j["size"], reducer="sum")
    wl.write(agg, "q_partkey_out")
    return wl


def drift_tables(n_lineitem: int = 6000, n_orders: int = 1500,
                 n_parts: int = 300, seed: int = 0,
                 skew: float = 0.0) -> Dict[str, Dict[str, np.ndarray]]:
    """Synthetic TPC-H-ish tables.  All payloads are integer-valued so
    keyed float sums are exact (bit-identical across layouts).  ``skew>0``
    draws lineitem orderkeys from a Zipf-like tail — the skewed-keys
    scenario (padding waste shows up in ``StoredDataset.skew()``)."""
    rng = np.random.default_rng(seed)
    if skew > 0:
        li_orderkey = zipf_keys(n_lineitem, n_orders, 1.0 + skew, rng=rng)
    else:
        li_orderkey = rng.integers(0, n_orders, n_lineitem)
    lineitem = {"orderkey": li_orderkey,
                "partkey": rng.integers(0, n_parts, n_lineitem),
                "qty": rng.integers(1, 50, n_lineitem).astype(np.float32),
                "price": rng.integers(50, 150,
                                      n_lineitem).astype(np.float32)}
    orders = {"orderkey": np.arange(n_orders, dtype=np.int64),
              "odate": rng.integers(0, 90, n_orders).astype(np.int32)}
    part = {"partkey": np.arange(n_parts, dtype=np.int64),
            "size": rng.integers(1, 50, n_parts).astype(np.int32)}
    return {"lineitem": lineitem, "orders": orders, "part": part}


def aggregate_result(vals, workload) -> Dict[str, np.ndarray]:
    """Canonical (key-sorted) columns of the workload's final aggregate —
    hash layouts give every key exactly one output row, so sorting by key
    makes results comparable bit-for-bit across layout generations."""
    node = max(n for n, nd in workload.graph.nodes.items()
               if nd.kind == "aggregate")
    tv = vals[node]
    order = np.argsort(tv.columns["key"], kind="stable")
    return {k: np.ascontiguousarray(np.asarray(v)[order])
            for k, v in tv.columns.items()}


# -- the scenario ------------------------------------------------------------

@dataclass
class RunSummary:
    wall_s: float
    shuffles: int
    elided: int
    shuffle_bytes: int
    device_repartitions: int

    @classmethod
    def of(cls, stats: EngineStats) -> "RunSummary":
        return cls(wall_s=stats.wall_s, shuffles=stats.shuffles_performed,
                   elided=stats.shuffles_elided,
                   shuffle_bytes=stats.shuffle_bytes,
                   device_repartitions=stats.device_repartitions)


@dataclass
class DriftScenarioReport:
    store: PartitionStore
    session: Session
    autopilot: Autopilot
    phase_a: List[RunSummary] = field(default_factory=list)
    tick_a: Optional[TickReport] = None
    post_a: Optional[RunSummary] = None
    result_pre_a: Optional[Dict[str, np.ndarray]] = None
    result_post_a: Optional[Dict[str, np.ndarray]] = None
    phase_b: List[RunSummary] = field(default_factory=list)
    tick_b_mid: Optional[TickReport] = None   # early tick: lineitem/orders
    tick_b: Optional[TickReport] = None       # still cooling down
    post_b: Optional[RunSummary] = None
    result_pre_b: Optional[Dict[str, np.ndarray]] = None
    result_post_b: Optional[Dict[str, np.ndarray]] = None
    lineitem_generations: List[int] = field(default_factory=list)
    lineitem_partitioners: List[str] = field(default_factory=list)


def default_drift_config() -> AutopilotConfig:
    """Recency window short enough that phase-A workloads age out during
    phase B — the knob that makes the service *follow* the drift.

    Hysteresis sits at 1.0 (not the service default 1.5): the first
    repartition's measured wall includes the candidate key-projection's
    one-time jit compile, which understates repartition throughput on a
    cold process; the cooldown and same-signature checks remain the
    flip-flop guards, and the scenario stays deterministic with a wide
    gate margin instead of a knife-edge one."""
    return AutopilotConfig(window_s=6.0, hysteresis=1.0, min_runs=2.0,
                           cooldown_ticks=1)


def run_drift_scenario(*, backend: str = "device", device="cuda",
                       num_workers: int = 8,
                       n_lineitem: int = 12000, n_orders: int = 1500,
                       n_parts: int = 300, seed: int = 0, skew: float = 0.0,
                       phase_a_runs: int = 3, phase_b_runs: int = 6,
                       config: Optional[AutopilotConfig] = None,
                       selector=None) -> DriftScenarioReport:
    """Run the full drift scenario deterministically via ``tick()``.

    Runs on the card unless the caller asks for the CPU (``device="cpu"``
    or ``backend="host"``), like :class:`~repro_torch.api.Session`; the
    reference defaults to ``backend="host"``."""
    tables = drift_tables(n_lineitem, n_orders, n_parts, seed, skew)
    store = PartitionStore(num_workers=num_workers, backend=backend,
                           device=device)
    for name, data in tables.items():
        store.write(name, data)                       # round-robin seed
    session = Session(store, backend=backend)
    ap = session.autopilot(clock=LogicalClock(),
                           config=config or default_drift_config(),
                           selector=selector)
    rep = DriftScenarioReport(store=store, session=session, autopilot=ap)

    def snap_lineitem():
        ds = store.read("lineitem")
        rep.lineitem_generations.append(ds.generation)
        rep.lineitem_partitioners.append(
            ds.partitioner.signature() if ds.partitioner else "none")

    wl_a, wl_b = q_orderkey(), q_partkey()
    snap_lineitem()

    # phase A: orderkey mix — every run observed, shuffles paid
    for i in range(phase_a_runs):
        vals, stats = session.run(wl_a)
        rep.phase_a.append(RunSummary.of(stats))
        if i == 0:
            rep.result_pre_a = aggregate_result(vals, wl_a)
    rep.tick_a = ap.tick()                            # decide + apply + swap
    snap_lineitem()
    vals, stats = session.run(wl_a)                    # post-decision run
    rep.post_a = RunSummary.of(stats)
    rep.result_post_a = aggregate_result(vals, wl_a)

    # phase B: the mix drifts to partkey joins.  An early tick lands inside
    # lineitem/orders' post-swap cooldown, so it cannot flip them yet (the
    # flip-flop guard); `part` — new traffic, no cooldown — may be acted on.
    for i in range(phase_b_runs):
        vals, stats = session.run(wl_b)
        rep.phase_b.append(RunSummary.of(stats))
        if i == 0:
            rep.result_pre_b = aggregate_result(vals, wl_b)
        if i == 1:
            rep.tick_b_mid = ap.tick()
    rep.tick_b = ap.tick()                            # re-partition on drift
    snap_lineitem()
    vals, stats = session.run(wl_b)
    rep.post_b = RunSummary.of(stats)
    rep.result_post_b = aggregate_result(vals, wl_b)
    return rep
