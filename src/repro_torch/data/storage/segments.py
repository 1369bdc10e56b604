"""Segment files — one binary blob per column, per generation (DESIGN §10).

A segment is the raw C-order bytes of a column array **already in the
persistent padded layout** ``(m, capacity, ...)`` (DESIGN §2), so reading
it back is a single ``np.memmap`` — zero-copy, lazily paged, and directly
placeable on a device (the leading axis is the worker axis) without
any re-dispatch.  The dtype/shape live in the manifest, not the file: a
segment carries payload bytes only.

Durability protocol: segments are written to a temp name, flushed and
fsync'd, then atomically renamed into place.  A segment is only *reachable*
once a manifest referencing it is published (see manifest.py) — the
manifest is the commit point — so a crash mid-write leaves at worst an
orphaned temp/partial file that validation ignores.
"""

from __future__ import annotations

import os
import threading
from typing import Tuple

import numpy as np

__all__ = ["write_segment", "open_segment", "read_segment",
           "segment_valid", "fsync_dir"]


def fsync_dir(path: str) -> None:
    """fsync a directory so renames inside it are durable (best-effort —
    not all platforms/filesystems allow opening a directory)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_segment(path: str, array: np.ndarray) -> int:
    """Persist ``array``'s bytes at ``path`` (temp + fsync + atomic rename).
    Returns the byte count written.

    The temp name is unique per writing thread: two threads racing to
    persist the same (name, generation) — a ``flush()`` against a
    concurrent spill — each complete their own temp file and the renames
    commute (same bits), instead of interleaving writes into one temp."""
    arr = np.ascontiguousarray(np.asarray(array))
    tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        # the array's own buffer, byte for byte (no second host copy)
        f.write(arr.reshape(-1).view(np.uint8))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return int(arr.nbytes)


def segment_valid(path: str, nbytes: int) -> bool:
    """True iff the segment exists with exactly the manifest's byte count —
    the truncation check crash recovery falls back on."""
    try:
        return os.path.getsize(path) == int(nbytes)
    except OSError:
        return False


def open_segment(path: str, dtype: str, shape: Tuple[int, ...]) -> np.ndarray:
    """Zero-copy read-only view of a segment (``np.memmap``).

    The result is an ndarray subclass: every consumer of the padded layout
    (gather, shuffles, the copy to a device) works unchanged, and pages fault in
    lazily — this IS the cold-read rehydration path."""
    if any(int(s) == 0 for s in shape):
        return np.zeros(tuple(int(s) for s in shape), np.dtype(dtype))
    return np.memmap(path, dtype=np.dtype(dtype), mode="r",
                     shape=tuple(int(s) for s in shape))


def read_segment(path: str, dtype: str, shape: Tuple[int, ...]) -> np.ndarray:
    """Eager in-RAM copy of a segment (promotion out of the spilled state)."""
    return np.array(open_segment(path, dtype, shape))
