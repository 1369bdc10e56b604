"""Sharded, double-buffered input pipeline for LM training: a copy of the
JAX package's ``data/pipeline.py`` (numpy and threads), whose batches are
bit-equal to the reference's.

Design for 1000+ nodes: each host reads only its shard of the global batch
(host-sharded token stream), prefetches one step ahead (overlaps host compute
with device step), and tolerates stragglers by reissuing late shards
(`runtime/straggler.py`).  On this CPU container the "hosts" are simulated
by deterministic per-shard RNG streams, so restart/elastic tests can verify
exactly-once, in-order delivery after failures.
"""

from __future__ import annotations

import collections
import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    seed: int = 0


class TokenSource:
    """Deterministic synthetic token stream, seekable by (step, host).

    Seekability is the fault-tolerance primitive: a restart from checkpoint
    step S reproduces exactly the batches S, S+1, ... with no data loss or
    duplication, on any host layout (elastic re-sharding re-derives streams).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.num_hosts == 0
        self.per_host = cfg.global_batch // cfg.num_hosts

    def batch_at(self, step: int, host: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 4096 + host)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              size=(self.per_host, self.cfg.seq_len),
                              dtype=np.int32)
        # next-token labels; last position wraps (synthetic stream)
        labels = np.roll(tokens, -1, axis=1)
        return {"tokens": tokens, "labels": labels}

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        shards = [self.batch_at(step, h) for h in range(self.cfg.num_hosts)]
        return {k: np.concatenate([s[k] for s in shards], axis=0)
                for k in shards[0]}


class PrefetchingLoader:
    """One-step-ahead prefetch: overlaps batch synthesis with device compute.

    The thread produces into a depth-1 queue; `__next__` pops.  This is the
    host-side half of compute/comm overlap — the device-side half is XLA's
    async collectives and donated buffers.
    """

    def __init__(self, source: TokenSource, start_step: int = 0,
                 prefetch_depth: int = 2):
        self.source = source
        self.step = start_step
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.source.global_batch_at(s)
            try:
                self._q.put((s, batch), timeout=1.0)
                s += 1
            except queue_mod.Full:
                continue

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue_mod.Empty:
            pass
        self._thread.join(timeout=2.0)
