"""Variable per-partition capacity layout (skew-adaptive storage).

The padded ``(m, capacity)`` layout sizes every partition for the fullest
one, so a single hot key inflates padding bytes for all ``m`` partitions.
A :class:`CapacityMap` gives each partition its own power-of-two capacity
bucket: hot partitions keep a large bucket while cold partitions share
small ones.  Columns of a bucketed dataset are stored *flat* as
``(total_slots,) + trailing`` with partition ``i`` occupying the slot
range ``[offsets[i], offsets[i] + capacities[i])``.

Power-of-two bucketing keeps the set of distinct capacities small, so the
jitted shuffle plans (keyed on the padded output row count, see
``device_repartition.shape_bucket``) stay bounded across skew levels: the
capacities ride through the trace as a regular traced array, never as a
static shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "CapacityMap",
    "bucket_capacity",
    "plan_capacity_map",
    "valid_slot_index",
]


def bucket_capacity(count: int) -> int:
    """Round ``count`` up to its power-of-two capacity bucket (0 stays 0)."""
    c = int(count)
    if c <= 0:
        return 0
    return 1 << (c - 1).bit_length()


@dataclass(frozen=True)
class CapacityMap:
    """Per-partition slot capacities + exclusive-prefix-sum offsets.

    ``capacities[i]`` is the number of slots reserved for partition ``i``;
    ``offsets[i]`` is where partition ``i`` starts in the flat slot axis.
    Instances are immutable and shared across dataset generations.
    """

    capacities: np.ndarray  # (m,) int64
    offsets: np.ndarray  # (m,) int64, exclusive prefix sum
    total_slots: int

    @classmethod
    def of(cls, capacities: Sequence[int]) -> "CapacityMap":
        caps = np.asarray(capacities, dtype=np.int64)
        offs = np.zeros_like(caps)
        if caps.size:
            np.cumsum(caps[:-1], out=offs[1:])
        cm = cls(capacities=caps, offsets=offs, total_slots=int(caps.sum()))
        caps.setflags(write=False)
        offs.setflags(write=False)
        return cm

    @classmethod
    def uniform(cls, m: int, capacity: int) -> "CapacityMap":
        return cls.of(np.full(int(m), int(capacity), dtype=np.int64))

    @classmethod
    def from_counts(cls, counts: Sequence[int]) -> "CapacityMap":
        """Bucket each partition's row count to its own power-of-two."""
        caps = np.asarray(
            [bucket_capacity(c) for c in np.asarray(counts, dtype=np.int64)],
            dtype=np.int64,
        )
        return cls.of(caps)

    @property
    def num_partitions(self) -> int:
        return int(self.capacities.shape[0])

    def bucket_set(self) -> Tuple[int, ...]:
        """Sorted distinct non-zero capacities (small by construction)."""
        return tuple(sorted({int(c) for c in self.capacities if c > 0}))

    def is_uniform(self) -> bool:
        if not self.capacities.size:
            return True
        return bool((self.capacities == self.capacities[0]).all())

    def __eq__(self, other: object) -> bool:  # frozen dataclass w/ arrays
        if not isinstance(other, CapacityMap):
            return NotImplemented
        return self.total_slots == other.total_slots and np.array_equal(
            self.capacities, other.capacities
        )

    def __hash__(self) -> int:
        return hash((self.total_slots, self.capacities.tobytes()))


def plan_capacity_map(
    counts: Sequence[int], threshold: float = 0.75
) -> Optional[CapacityMap]:
    """Propose a bucketed layout for ``counts``, or None to stay uniform.

    Returns a :class:`CapacityMap` only when the bucketed total slot count
    is at most ``threshold`` of the uniform layout's ``m * max(counts)``
    (i.e. the re-layout saves at least ``1 - threshold`` of the padding).
    """
    cnts = np.asarray(counts, dtype=np.int64)
    if cnts.size == 0 or int(cnts.sum()) == 0:
        return None
    uniform_total = int(cnts.shape[0]) * bucket_capacity(int(cnts.max()))
    cm = CapacityMap.from_counts(cnts)
    if uniform_total <= 0 or cm.total_slots > threshold * uniform_total:
        return None
    return cm


def valid_slot_index(counts: Sequence[int], offsets: Sequence[int]) -> np.ndarray:
    """Flat slot indices of the valid rows, worker-major in rank order.

    This is the single source of truth for gather/flatten ordering: row
    ``r`` of partition ``i`` lives at slot ``offsets[i] + r``, and valid
    rows are enumerated partition-by-partition.  Both the uniform layout
    (``offsets = arange(m) * capacity``) and bucketed layouts share it,
    which is what makes the two layouts bit-identical on read.
    """
    cnts = np.asarray(counts, dtype=np.int64)
    offs = np.asarray(offsets, dtype=np.int64)
    n = int(cnts.sum())
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.repeat(offs, cnts)
    # rank within partition: arange(n) minus each partition's first global row
    row_starts = np.repeat(np.cumsum(cnts) - cnts, cnts)
    return starts + (np.arange(n, dtype=np.int64) - row_starts)
