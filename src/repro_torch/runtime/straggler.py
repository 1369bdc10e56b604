"""Straggler mitigation for the data path.

Synchronous SPMD can't drop a slow *device*, but the host-side data pipeline
can and must tolerate slow shards: the dominant production straggler mode is
a host whose input shard is late.  We reissue late shards to backup hosts
(speculative execution, MapReduce-style) and take whichever copy lands
first; the deterministic TokenSource makes duplicates byte-identical so the
race is benign.

Detection: a shard is a straggler once its latency exceeds
``factor ×`` the running p50 over a sliding window.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class StragglerConfig:
    factor: float = 2.0          # straggler if latency > factor * p50
    window: int = 64             # sliding window of completed shard times
    min_samples: int = 8


class StragglerMitigator:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.samples: Deque[float] = deque(maxlen=cfg.window)
        self.reissues = 0
        self.detections: List[Tuple[int, int, float]] = []   # (step, host, lat)

    def threshold(self) -> Optional[float]:
        if len(self.samples) < self.cfg.min_samples:
            return None
        return float(np.percentile(self.samples, 50)) * self.cfg.factor

    def record(self, latency: float) -> None:
        self.samples.append(latency)

    def fetch_shard(self, fetch: Callable[[int, int], dict], step: int,
                    host: int, backup_host: int,
                    simulated_latency: Optional[float] = None) -> dict:
        """Fetch one host's shard; reissue to a backup if it straggles.

        ``simulated_latency`` lets tests inject slowness without sleeping."""
        t0 = time.perf_counter()
        shard = fetch(step, host)
        lat = (simulated_latency if simulated_latency is not None
               else time.perf_counter() - t0)
        thr = self.threshold()
        if thr is not None and lat > thr:
            self.detections.append((step, host, lat))
            self.reissues += 1
            # backup host recomputes the SAME (step, host) shard; determinism
            # of TokenSource makes the duplicate byte-identical
            shard = fetch(step, host)
        self.record(lat)
        return shard
