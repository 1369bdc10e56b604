"""Regression watchdog (DESIGN §15): rolling telemetry windows vs a
recorded baseline.

A :class:`RegressionDetector` reads the headline series out of the
durable :class:`~repro_torch.obs.telemetry.TelemetryStore` — run wall p50,
retraces per run, padding waste ratio — plus the serving tier's
coalesce rate from the live :class:`MetricsRegistry`, and compares a
rolling window of them against a baseline recorded with
:meth:`record_baseline` (persisted as ``telemetry/baseline.json``, so
the comparison survives restarts like everything else here).

When a series regresses beyond ``tolerance`` it emits a
``perf_regression`` signal with the ``kind/node/step/detail`` fields and
the drain-once :meth:`signals` protocol of the cluster tier's health
signals (the JAX package's ``ClusterSignal``), so an Autopilot tick can
consume both through one signal path.  Signals are deduped:
a series alerts once per excursion and re-arms only after it recovers
below the threshold, so a sustained regression is one alert, not one
per tick.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .telemetry import TelemetryStore

__all__ = ["RegressionDetector", "WatchdogSignal", "WATCHDOG_SERIES"]

#: headline series → True when a larger value is worse (run wall,
#: retraces, padding waste) and False when a *smaller* value is worse
#: (coalesce rate: fewer coalesced serves per completed serve means the
#: serving tier stopped deduplicating identical requests)
WATCHDOG_SERIES: Dict[str, bool] = {
    "run_wall_p50_s": True,
    "retraces_per_run": True,
    "padding_waste_ratio": True,
    "coalesce_rate": False,
}


@dataclass
class WatchdogSignal:
    """Shaped like the cluster tier's health signal (``kind``, ``node``,
    ``step``, ``detail``), so one code path can price both."""
    kind: str
    node: str                     # the regressing series name
    step: int = 0
    detail: Dict[str, Any] = field(default_factory=dict)


class RegressionDetector:
    """Compare rolling telemetry windows against a recorded baseline."""

    def __init__(self, telemetry: TelemetryStore, window: int = 32,
                 tolerance: float = 1.25, min_runs: int = 8,
                 registry: Any = None):
        if tolerance <= 1.0:
            raise ValueError("tolerance must be > 1.0")
        self.telemetry = telemetry
        self.window = int(window)
        self.tolerance = float(tolerance)
        self.min_runs = int(min_runs)
        self.registry = registry              # optional (coalesce rate)
        self.baseline_path = os.path.join(telemetry.dir, "baseline.json")
        self._signalled: set = set()          # series currently alerting
        self._pending: List[WatchdogSignal] = []
        self.raised_total = 0
        self.checks = 0

    # -- series extraction ---------------------------------------------------
    def window_stats(self) -> Dict[str, Optional[float]]:
        """Current values of every watched series over the newest
        ``window`` runs (None where undefined — e.g. no serving traffic)."""
        profiles = self.telemetry.run_profiles(limit=self.window)
        out: Dict[str, Optional[float]] = {k: None for k in WATCHDOG_SERIES}
        out["runs"] = float(len(profiles))
        if profiles:
            walls = sorted(p.wall_s for p in profiles)
            out["run_wall_p50_s"] = walls[len(walls) // 2]
            out["retraces_per_run"] = (
                sum(p.retraces for p in profiles) / len(profiles))
            valid = sum(p.valid_bytes for p in profiles)
            padded = sum(p.padded_bytes for p in profiles)
            if valid > 0:
                out["padding_waste_ratio"] = padded / valid
        out["coalesce_rate"] = self._coalesce_rate()
        return out

    def _coalesce_rate(self) -> Optional[float]:
        if self.registry is None:
            return None
        try:
            snap = self.registry.snapshot()["metrics"]
        except Exception:       # noqa: BLE001 — watchdog never takes
            return None         # down the loop it watches
        completed = sum(s.get("value", 0.0) for s in
                        snap.get("serving_completed",
                                 {}).get("samples", []))
        coalesced = sum(s.get("value", 0.0) for s in
                        snap.get("serving_coalesced",
                                 {}).get("samples", []))
        if completed <= 0:
            return None
        return coalesced / completed

    # -- baseline ------------------------------------------------------------
    def record_baseline(self) -> Dict[str, Any]:
        """Freeze the current window as the comparison baseline."""
        doc = {"version": 1, "recorded_unix_s": time.time(),
               "window": self.window, "tolerance": self.tolerance,
               "stats": self.window_stats()}
        tmp = self.baseline_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, self.baseline_path)
        return doc

    def baseline(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.baseline_path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if int(doc.get("version", 1)) > 1:
            return None                       # future schema — ignore
        return doc

    # -- checking ------------------------------------------------------------
    def check(self, step: int = 0) -> List[WatchdogSignal]:
        """Compare the current window to the baseline; queue one deduped
        ``perf_regression`` signal per newly-regressing series.  No-op
        (returns []) without a baseline or with too few runs."""
        self.checks += 1
        base = self.baseline()
        if base is None:
            return []
        cur = self.window_stats()
        if (cur.get("runs") or 0) < self.min_runs:
            return []
        tol = float(base.get("tolerance", self.tolerance))
        new: List[WatchdogSignal] = []
        for series, higher_is_worse in WATCHDOG_SERIES.items():
            b = base.get("stats", {}).get(series)
            c = cur.get(series)
            if b is None or c is None or b <= 0:
                continue
            ratio = c / b
            regressed = (ratio > tol) if higher_is_worse \
                else (ratio < 1.0 / tol)
            if regressed:
                if series in self._signalled:
                    continue                  # dedupe: one alert/excursion
                self._signalled.add(series)
                self.raised_total += 1
                sig = WatchdogSignal(
                    kind="perf_regression", node=series, step=step,
                    detail={"series": series, "observed": c, "baseline": b,
                            "ratio": ratio, "tolerance": tol,
                            "higher_is_worse": higher_is_worse,
                            "window_runs": cur.get("runs")})
                new.append(sig)
                self._pending.append(sig)
            else:
                self._signalled.discard(series)   # recovered — re-arm
        return new

    def signals(self) -> List[WatchdogSignal]:
        """Drain queued signals (the ClusterHealth protocol)."""
        out, self._pending = self._pending, []
        return out

    def stats(self) -> Dict[str, Any]:
        return {"checks": self.checks, "raised_total": self.raised_total,
                "alerting": sorted(self._signalled),
                "has_baseline": os.path.exists(self.baseline_path),
                "window": self.window, "tolerance": self.tolerance}
