"""Durable columnar storage tier under the PartitionStore API (DESIGN §10).

The persistence the paper's "reused across applications" claim needs:
per-generation segment files in the padded ``(m, capacity, ...)`` layout
(zero-copy ``np.memmap`` reopen), crash-safe JSON manifests published by
write-temp-then-atomic-rename, bounded on-disk generation retention, an
Autopilot decision log, and memory-budget spill/rehydrate hooks.

Construct through the front door — ``PartitionStore(root=...)`` /
``PartitionStore.open(root)`` / ``lachesis.Session(store_path=...)`` —
rather than using :class:`DurableStore` directly.
"""

from .durable import DurableStore
from .manifest import (Manifest, RestoredPartitioner, decode_partitioner,
                       encode_partitioner, load_current)
from .segments import open_segment, read_segment, segment_valid, write_segment

__all__ = [
    "DurableStore", "Manifest", "RestoredPartitioner",
    "encode_partitioner", "decode_partitioner", "load_current",
    "open_segment", "read_segment", "segment_valid", "write_segment",
]
