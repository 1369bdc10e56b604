"""Fault tolerance: heartbeats, failure detection, restart policy.

At 1000+ nodes, node loss is routine.  The control plane here is
deliberately simple and deterministic so it can be tested on one host:

* every worker posts a heartbeat each step; the coordinator marks a worker
  failed after ``miss_threshold`` missed beats;
* on failure, the run transitions to RECOVERING: the coordinator picks the
  restart step (latest complete checkpoint), computes the surviving-node
  mesh via :mod:`repro_torch.runtime.elastic`, and replays the data stream from
  the checkpoint cursor (exactly-once — see data/pipeline.TokenSource);
* repeated failures back off exponentially to avoid restart storms.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional


class RunState(Enum):
    RUNNING = "running"
    RECOVERING = "recovering"
    FAILED = "failed"


@dataclass
class WorkerHealth:
    last_beat_step: int = 0
    missed: int = 0
    alive: bool = True


@dataclass
class FailureEvent:
    step: int
    worker: int
    restart_step: int


class Coordinator:
    def __init__(self, num_workers: int, miss_threshold: int = 3,
                 max_restarts: int = 10):
        self.workers: Dict[int, WorkerHealth] = {
            w: WorkerHealth() for w in range(num_workers)}
        self.miss_threshold = miss_threshold
        self.max_restarts = max_restarts
        self.state = RunState.RUNNING
        self.events: List[FailureEvent] = []
        self.restarts = 0

    def heartbeat(self, worker: int, step: int) -> None:
        h = self.workers[worker]
        h.last_beat_step = step
        h.missed = 0

    def tick(self, step: int, checkpoint_step: int) -> Optional[FailureEvent]:
        """Advance failure detection one step; returns an event on failure."""
        for w, h in self.workers.items():
            if not h.alive:
                continue
            if h.last_beat_step < step:
                h.missed += 1
            if h.missed >= self.miss_threshold:
                h.alive = False
                self.restarts += 1
                ev = FailureEvent(step=step, worker=w,
                                  restart_step=checkpoint_step)
                self.events.append(ev)
                self.state = (RunState.FAILED
                              if self.restarts > self.max_restarts
                              else RunState.RECOVERING)
                return ev
        return None

    def alive_workers(self) -> List[int]:
        return [w for w, h in self.workers.items() if h.alive]

    def backoff_s(self) -> float:
        return min(60.0, 0.1 * (2 ** max(0, self.restarts - 1)))

    def recover(self) -> None:
        if self.state == RunState.RECOVERING:
            self.state = RunState.RUNNING


def run_with_restarts(train_fn: Callable[[int], int], *, total_steps: int,
                      coordinator: Coordinator,
                      restore_fn: Callable[[], int],
                      max_attempts: int = 12) -> int:
    """Drive ``train_fn(start_step) -> reached_step`` to completion across
    simulated failures; ``restore_fn`` yields the checkpointed restart step."""
    step = 0
    for _attempt in range(max_attempts):
        try:
            step = train_fn(step)
            if step >= total_steps:
                return step
        except WorkerFailure:
            step = restore_fn()
            coordinator.recover()
    raise RuntimeError("exceeded max restart attempts")


class WorkerFailure(RuntimeError):
    pass
