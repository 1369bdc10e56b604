"""What-if cost model for candidate layouts (DESIGN §8).

Answers the optimizer's question: *if dataset D were repartitioned into
candidate layout c, how many seconds of shuffle work would the observed
workload mix stop paying, and what does the repartition itself cost?*

Benefit side — for every skeleton group in history whose IR scans D, Alg. 4
(:func:`~repro_torch.core.matching.partitioning_match`) counts the partition
nodes that layout c would elide versus the count the *current* layout
already elides; the delta, times the group's run rate inside the recency
window, times the modeled per-shuffle seconds, is the benefit rate.  Using
the exact matcher means the model never predicts an elision the planner
won't actually compile into the PhysicalPlan (DESIGN §9: the same Alg. 4
check runs statically at plan time).

Cost side — one full repartition of D's bytes.

Both sides are priced from **measured shuffle throughput**, calibrated from
two sources: live timings (the Observer feeds every run's
``shuffle_bytes / shuffle_s``) and benchmark snapshots
(:meth:`WhatIfCostModel.load_bench_json` parses the repartition rows; the
repo's committed ``BENCH_*.json`` are CPU runs of the JAX package, and
nothing in the port loads them).  With neither, the paper's 10 Gbps
cluster bandwidth is the prior.

Durable stores (DESIGN §10) add an **I/O side**: applying a layout to a
store with ``root=`` also writes the new generation's segments, and a
spilled source must be rehydrated off disk first.  Those bytes are priced
at the measured storage throughput (the Observer feeds every run's
``storage_io_bytes / storage_io_s``; the Autopilot feeds each applied
decision's flush) with an NVMe-class prior before any sample arrives.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.history import HistoryStore
from ..core.matching import partitioning_match
from ..core.partitioner import PartitionerCandidate

DEFAULT_BANDWIDTH = 1.25e9          # 10 Gbps — the paper's cluster prior
DEFAULT_DISK_BANDWIDTH = 2e9        # NVMe-class prior for the durable tier


@dataclass
class Calibration:
    """Running bytes/seconds totals → measured throughput."""
    bytes_total: float = 0.0
    seconds_total: float = 0.0
    samples: int = 0

    def observe(self, nbytes: float, seconds: float) -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        self.bytes_total += float(nbytes)
        self.seconds_total += float(seconds)
        self.samples += 1

    def throughput(self) -> Optional[float]:
        if self.seconds_total <= 0:
            return None
        return self.bytes_total / self.seconds_total


@dataclass
class LayoutScore:
    """What-if verdict for one (dataset, candidate) pair."""
    dataset: str
    candidate_signature: str
    benefit_s: float          # window'd shuffle seconds saved per window
    repartition_s: float      # modeled one-time cost of applying the layout
    runs_in_window: float     # consumer runs (weight-aware) that scanned D
    shuffles_delta: float     # Σ runs × (elisions_new − elisions_current)
    io_s: float = 0.0         # durable-tier I/O: rehydrate spilled source +
                              # persist the new generation (DESIGN §10)
    padding_benefit_s: float = 0.0   # per-window seconds saved by shrinking
                                     # padded-layout bytes (DESIGN §12)

    @property
    def apply_cost_s(self) -> float:
        """Total one-time cost of applying the layout (shuffle + I/O)."""
        return self.repartition_s + self.io_s

    @property
    def net_s(self) -> float:
        return self.benefit_s + self.padding_benefit_s - self.apply_cost_s

    def explain(self, hysteresis: float, horizon: float = 1.0) -> Dict:
        """The gate math as data — every priced component plus both sides
        of the :meth:`worth_it` inequality, so a why-record can show
        exactly how close a rejected candidate came."""
        amortized = (self.benefit_s + self.padding_benefit_s) * horizon
        gated = hysteresis * self.apply_cost_s
        return {
            "benefit_s": float(self.benefit_s),
            "padding_benefit_s": float(self.padding_benefit_s),
            "repartition_s": float(self.repartition_s),
            "io_s": float(self.io_s),
            "apply_cost_s": float(self.apply_cost_s),
            "net_s": float(self.net_s),
            "runs_in_window": float(self.runs_in_window),
            "shuffles_delta": float(self.shuffles_delta),
            "hysteresis": float(hysteresis),
            "horizon_windows": float(horizon),
            "amortized_benefit_s": float(amortized),
            "gated_cost_s": float(gated),
        }

    def worth_it(self, hysteresis: float, horizon: float = 1.0) -> bool:
        """Modeled benefit must clear the one-time apply cost (repartition
        shuffle + any durable-tier I/O) by the hysteresis factor — the
        flip-flop guard.  ``horizon`` is the number of future recency
        windows the new layout is expected to stay useful: ``benefit_s`` is
        a per-window rate while the apply cost is paid once, so the gate
        amortizes exactly like Eq. 2 trades the producer-side cost against
        future consumer runs."""
        return (self.benefit_s + self.padding_benefit_s) * horizon \
            > hysteresis * self.apply_cost_s


class WhatIfCostModel:
    def __init__(self, default_bandwidth: float = DEFAULT_BANDWIDTH,
                 bench_path: Optional[str] = None,
                 default_disk_bandwidth: float = DEFAULT_DISK_BANDWIDTH):
        self.default_bandwidth = default_bandwidth
        self.default_disk_bandwidth = default_disk_bandwidth
        self.shuffle_cal = Calibration()
        self.repartition_cal = Calibration()
        self.io_cal = Calibration()
        if bench_path:
            self.load_bench_json(bench_path)

    # -- calibration --------------------------------------------------------
    def observe_shuffle(self, nbytes: float, seconds: float) -> None:
        self.shuffle_cal.observe(nbytes, seconds)

    def observe_repartition(self, nbytes: float, seconds: float) -> None:
        self.repartition_cal.observe(nbytes, seconds)

    def observe_io(self, nbytes: float, seconds: float) -> None:
        """Durable-tier sample: segment bytes moved / wall seconds (spill
        flushes, rehydration reads, autoflushed generations)."""
        self.io_cal.observe(nbytes, seconds)

    def load_bench_json(self, path: str) -> int:
        """Best-effort calibration from a committed BENCH_*.json snapshot:
        every ``repartition*`` row whose derived string carries a
        ``bytes=`` figure contributes a throughput sample.  Returns the
        number of samples loaded (0 on parse trouble — never raises)."""
        loaded = 0
        try:
            with open(path) as f:
                rows = json.load(f).get("rows", [])
        except (OSError, ValueError):
            return 0
        for row in rows:
            try:
                if not str(row.get("name", "")).startswith("repartition"):
                    continue
                mb = re.search(r"bytes=(\d+)", str(row.get("derived", "")))
                us = float(row.get("us_per_call", 0.0))
                if mb and us > 0:
                    self.repartition_cal.observe(float(mb.group(1)),
                                                 us * 1e-6)
                    loaded += 1
            except (TypeError, ValueError):
                continue
        return loaded

    # -- modeled times ------------------------------------------------------
    def shuffle_throughput(self) -> float:
        t = self.shuffle_cal.throughput()
        if t is None:
            t = self.repartition_cal.throughput()
        return t if t is not None else self.default_bandwidth

    def repartition_throughput(self) -> float:
        t = self.repartition_cal.throughput()
        if t is None:
            t = self.shuffle_cal.throughput()
        return t if t is not None else self.default_bandwidth

    def shuffle_seconds(self, nbytes: float, num_workers: int) -> float:
        """One consumer-side shuffle of the dataset: (m-1)/m of the bytes
        re-bucket (rows landing on their own worker don't move)."""
        frac = (num_workers - 1) / num_workers if num_workers > 1 else 0.0
        return nbytes * frac / self.shuffle_throughput()

    def repartition_seconds(self, nbytes: float) -> float:
        return nbytes / self.repartition_throughput()

    def io_throughput(self) -> float:
        t = self.io_cal.throughput()
        return t if t is not None else self.default_disk_bandwidth

    def io_seconds(self, nbytes: float) -> float:
        """Durable-tier transfer time for ``nbytes`` of segment data."""
        return nbytes / self.io_throughput()

    def rebalance_seconds(self, moved_bytes: float) -> float:
        """Modeled wall time of an incremental cluster rebalance (DESIGN
        §14): the moved partitions' segment bytes stream node-to-node at
        the calibrated segment-I/O throughput — unchanged parts are
        hard-linked, so only the minimal move set is priced."""
        return self.io_seconds(max(float(moved_bytes), 0.0))

    def padding_overhead_s(self, padded_bytes: float,
                           valid_bytes: float) -> float:
        """Per-run seconds a padded layout wastes moving padding (DESIGN
        §12): the padded-vs-valid byte gap priced at storage throughput —
        padding is paid on every segment write/spill/rehydrate and every
        memmap page-in, which the durable calibration already measures."""
        return max(padded_bytes - valid_bytes, 0.0) / self.io_throughput()

    # -- what-if scoring ----------------------------------------------------
    @staticmethod
    def elisions_per_run(candidate: Optional[PartitionerCandidate],
                         dataset: str, ir) -> int:
        """Partition nodes of one consumer IR that layout `candidate` lets
        the planner elide — the exact Alg. 4 check the planner compiles
        into the PhysicalPlan at plan time."""
        if candidate is None or not candidate.is_keyed:
            return 0
        return len(partitioning_match(candidate, dataset, ir).partition_nodes)

    def score(self, dataset: str, ds_bytes: float, num_workers: int,
              candidate: PartitionerCandidate,
              current: Optional[PartitionerCandidate],
              history: HistoryStore, *, now: float,
              window_s: float = float("inf"),
              groups: Optional[Dict] = None,
              durable: bool = False,
              source_spilled: bool = False,
              current_padded_bytes: float = 0.0,
              current_valid_bytes: float = 0.0,
              candidate_padded_bytes: Optional[float] = None,
              local: bool = False) -> LayoutScore:
        """What-if score of moving ``dataset`` from layout ``current`` to
        ``candidate``, against the run mix observed inside the recency
        window ``[now - window_s, now]`` (drifted-away workloads age out).
        Pass a prebuilt skeleton ``groups`` dict to amortize the graph
        build across many scores of one history snapshot.

        ``durable`` charges persisting the repartitioned generation's
        segments; ``source_spilled`` additionally charges rehydrating the
        evicted source off disk before it can be shuffled (DESIGN §10).

        Padding term (DESIGN §12): pass the current layout's
        padded/valid bytes plus the candidate layout's estimated padded
        bytes and the per-run padding-overhead delta is added to the
        benefit rate — how split/merge decisions pay for themselves even
        when they change no elision.  ``local=True`` prices the apply as a
        node-local rewrite (rebucket: same partitioner, no rows cross the
        network) at I/O throughput instead of a full shuffle."""
        per_shuffle_s = self.shuffle_seconds(ds_bytes, num_workers)
        io_s = 0.0
        if durable:
            io_s += self.io_seconds(ds_bytes)
        if source_spilled:
            io_s += self.io_seconds(ds_bytes)
        if groups is None:
            groups, _ = history.skeleton_graph()
        benefit = 0.0
        runs_in_window = 0.0
        shuffles_delta = 0.0
        for sig, group in groups.items():
            ir = history.ir_of(sig)
            if ir is None or ir.find_scanner(dataset) is None:
                continue
            rate = sum(r.weight for r in group.runs
                       if r.timestamp >= now - window_s)
            if rate <= 0:
                continue
            runs_in_window += rate
            delta = (self.elisions_per_run(candidate, dataset, ir)
                     - self.elisions_per_run(current, dataset, ir))
            shuffles_delta += rate * delta
            benefit += rate * delta * per_shuffle_s
        padding_benefit = 0.0
        if candidate_padded_bytes is not None and runs_in_window > 0:
            padding_benefit = runs_in_window * (
                self.padding_overhead_s(current_padded_bytes,
                                        current_valid_bytes)
                - self.padding_overhead_s(candidate_padded_bytes,
                                          current_valid_bytes))
        return LayoutScore(
            dataset=dataset, candidate_signature=candidate.signature(),
            benefit_s=benefit,
            repartition_s=(self.io_seconds(ds_bytes) if local
                           else self.repartition_seconds(ds_bytes)),
            runs_in_window=runs_in_window, shuffles_delta=shuffles_delta,
            io_s=io_s, padding_benefit_s=padding_benefit)
