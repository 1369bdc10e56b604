"""Elastic scaling: recompute the mesh after node loss/gain.

Policy: keep the model axis intact (TP sharding is layout-critical), shrink
the data axis to the largest size the surviving chip count supports, and
emit a deterministic resharding plan (which checkpoint shards each new
device loads).  Growing back follows the same path in reverse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def replan_mesh(current: MeshPlan, surviving_devices: int) -> MeshPlan:
    """Largest mesh ≤ surviving devices preserving the model axis.

    data axis shrinks to the largest power-of-two fit (keeps per-device
    batch integral when the global batch is a power-of-two multiple)."""
    axes = current.axes
    model = current.shape[-1]
    if surviving_devices < model:
        raise ValueError("fewer surviving devices than the model axis — "
                         "cannot preserve TP layout; full restart required")
    budget = surviving_devices // model
    data = 1
    while data * 2 <= budget:
        data *= 2
    if "pod" in axes:
        # collapse pod into data when a pod is degraded
        return MeshPlan((1, data, model), axes)
    return MeshPlan((data, model), axes)


def resharding_plan(old: MeshPlan, new: MeshPlan,
                    batch_dim: int) -> Dict[str, object]:
    """Deterministic plan for moving from ``old`` to ``new``:
    which old data-shard ranges each new data shard reads."""
    old_data = old.shape[-2] * (old.shape[0] if len(old.shape) == 3 else 1)
    new_data = new.shape[-2] * (new.shape[0] if len(new.shape) == 3 else 1)
    per_old = batch_dim // old_data
    per_new = batch_dim // new_data
    assignments: List[Dict] = []
    for d in range(new_data):
        lo, hi = d * per_new, (d + 1) * per_new
        src = sorted({lo // per_old, (hi - 1) // per_old})
        assignments.append({"new_shard": d, "rows": (lo, hi),
                            "reads_old_shards": src})
    return {"old": old, "new": new, "per_device_batch": per_new,
            "assignments": assignments}
