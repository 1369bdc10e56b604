"""DurableStore — the on-disk half of a PartitionStore (DESIGN §10).

Owns one store root directory::

    root/
      catalog.json            # store identity: format, num_workers
      decisions.log           # JSONL of Autopilot-applied decisions
      datasets/<name>/
        CURRENT               # pointer file — the only mutable byte
        manifest-000007.json  # immutable, one per generation
        gen-000007/<col>.seg  # padded-layout column blobs (np.memmap-able)

Every publish goes segments → manifest → CURRENT, each step atomic
(temp + fsync + rename), so the store reopens to a consistent generation
after a crash at any point.  Retired generations are garbage-collected
past the same ``max_retired_generations`` window the in-memory store
keeps, so disk usage stays bounded under sustained Autopilot traffic.

All I/O is metered into :attr:`io_stats` — the counters the executor
surfaces per run (``EngineStats.storage_io_*``).

Device columns (torch tensors on CUDA) come to the host once per persist,
through ``.cpu().numpy()``; that copy synchronizes, so ``write_s``
includes it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional
from urllib.parse import quote, unquote

import numpy as np

from ...core.ir import to_numpy
from ...obs.tracer import span as _span
from .manifest import (Manifest, atomic_write_text, decode_partitioner,
                       gen_dirname, list_generations, load_current,
                       load_manifest, manifest_filename, publish_manifest,
                       segment_filename)
from .segments import fsync_dir, open_segment, write_segment

__all__ = ["DurableStore", "CATALOG_FORMAT", "DECISIONS_SCHEMA_VERSION"]

CATALOG_FORMAT = 1
_GENERATION_LOG_CAP = 64     # manifest generation-log entries retained

#: schema version stamped into decisions.log JSONL rows.  v1 = the
#: pre-versioning applied-decision rows (no ``version`` field); v2 adds
#: the field itself plus the Autopilot's kind="why" explainability rows.
DECISIONS_SCHEMA_VERSION = 2


def _encode_name(name: str) -> str:
    """Filesystem-safe dataset directory name (reversible)."""
    return quote(name, safe="._@+-")


def _io_zero() -> Dict[str, float]:
    return {"bytes_written": 0, "write_s": 0.0,
            "bytes_read": 0, "read_s": 0.0,
            "segments_written": 0, "generations_published": 0,
            "spills": 0, "spilled_bytes": 0,
            "rehydrations": 0, "rehydrated_bytes": 0}


class DurableStore:
    """Filesystem backend for one PartitionStore root."""

    def __init__(self, root: str, *, num_workers: Optional[int] = None,
                 max_retired_generations: int = 2):
        self.root = os.path.abspath(root)
        self.max_retired_generations = int(max_retired_generations)
        self.io_stats: Dict[str, float] = _io_zero()
        # serializes io_stats read-modify-writes: many serving threads
        # meter I/O concurrently and must not lose increments
        self._io_lock = threading.Lock()
        os.makedirs(os.path.join(self.root, "datasets"), exist_ok=True)
        self.catalog = self._load_or_init_catalog(num_workers)

    # -- store-level catalog -------------------------------------------------
    @property
    def catalog_path(self) -> str:
        return os.path.join(self.root, "catalog.json")

    def _load_or_init_catalog(self, num_workers: Optional[int]) -> Dict:
        try:
            with open(self.catalog_path) as f:
                cat = json.load(f)
            if int(cat.get("format", 1)) > CATALOG_FORMAT:
                raise ValueError(
                    f"store at {self.root} uses catalog format "
                    f"{cat['format']} > supported {CATALOG_FORMAT}")
            return cat
        except OSError:
            pass
        cat = {"format": CATALOG_FORMAT,
               "num_workers": int(num_workers) if num_workers else None,
               "created_at": time.time()}
        atomic_write_text(self.catalog_path, json.dumps(cat, indent=1))
        return cat

    def io_add(self, **deltas: float) -> None:
        """Atomically add to the I/O counters (thread-safe metering)."""
        with self._io_lock:
            for k, v in deltas.items():
                self.io_stats[k] += v

    def io_snapshot(self) -> Dict[str, float]:
        with self._io_lock:
            return dict(self.io_stats)

    @property
    def num_workers(self) -> Optional[int]:
        m = self.catalog.get("num_workers")
        return int(m) if m else None

    # -- paths ---------------------------------------------------------------
    def dataset_dir(self, name: str, create: bool = False) -> str:
        d = os.path.join(self.root, "datasets", _encode_name(name))
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def dataset_names(self) -> List[str]:
        base = os.path.join(self.root, "datasets")
        try:
            return sorted(unquote(n) for n in os.listdir(base)
                          if os.path.isdir(os.path.join(base, n)))
        except OSError:
            return []

    def has_generation(self, name: str, generation: int) -> bool:
        return os.path.exists(os.path.join(
            self.dataset_dir(name), manifest_filename(generation)))

    # -- write path ----------------------------------------------------------
    def persist(self, ds, publish_current: bool = True) -> Manifest:
        """Durably publish one StoredDataset generation (idempotent for an
        already-published (name, generation) pair).

        ``publish_current=False`` writes the segments + manifest WITHOUT
        flipping the CURRENT pointer — used when materializing a retired
        (superseded) generation for spill, which must never move the
        store's visible head backwards."""
        t0 = time.perf_counter()
        with _span("durable.persist", "storage", dataset=ds.name,
                   generation=ds.generation) as sp:
            ds_dir = self.dataset_dir(ds.name, create=True)
            gdir = os.path.join(ds_dir, gen_dirname(ds.generation))
            os.makedirs(gdir, exist_ok=True)
            written = 0
            for k, v in ds.columns.items():
                # a device column crosses to the host here, exactly once
                written += write_segment(
                    os.path.join(gdir, segment_filename(k)), to_numpy(v))
                self.io_add(segments_written=1)
            fsync_dir(gdir)
            prev = load_manifest(ds_dir, ds.generation - 1) \
                if ds.generation > 0 else None
            man = Manifest.of_dataset(ds, prev)
            man.generation_log = man.generation_log[-_GENERATION_LOG_CAP:]
            if publish_current:
                publish_manifest(ds_dir, man)
                self._gc(ds_dir, ds.generation)
            else:
                atomic_write_text(
                    os.path.join(ds_dir, manifest_filename(man.generation)),
                    man.to_json())
            self.io_add(bytes_written=written,
                        write_s=time.perf_counter() - t0,
                        generations_published=1)
            sp.set(bytes=written)
            return man

    def _gc(self, ds_dir: str, current_gen: int) -> None:
        """Drop manifests + segment dirs older than the retention window."""
        keep_from = current_gen - self.max_retired_generations
        for g in list_generations(ds_dir):
            if g < keep_from:
                try:
                    os.remove(os.path.join(ds_dir, manifest_filename(g)))
                except OSError:
                    pass
                shutil.rmtree(os.path.join(ds_dir, gen_dirname(g)),
                              ignore_errors=True)
        fsync_dir(ds_dir)

    # -- read path -----------------------------------------------------------
    def open_columns(self, name: str, man: Manifest) -> Dict[str, np.ndarray]:
        """memmap views of every segment of ``man`` (zero-copy; pages fault
        in lazily on first touch)."""
        ds_dir = self.dataset_dir(name)
        return {k: open_segment(os.path.join(ds_dir, spec["file"]),
                                spec["dtype"], tuple(spec["shape"]))
                for k, spec in sorted(man.columns.items())}

    def load_manifest(self, name: str,
                      generation: Optional[int] = None) -> Optional[Manifest]:
        ds_dir = self.dataset_dir(name)
        if generation is None:
            return load_current(ds_dir)
        man = load_manifest(ds_dir, generation)
        if man is not None and not man.validate(ds_dir):
            return None
        return man

    def load(self, name: str, generation: Optional[int] = None):
        """Reopen ``name`` as a memmap-backed StoredDataset (the current
        generation, or a specific retained one).  None when nothing
        consistent is on disk."""
        from ..capacity import CapacityMap            # deferred: cycle
        from ..partition_store import StoredDataset   # deferred: cycle
        man = self.load_manifest(name, generation)
        if man is None:
            return None
        t0 = time.perf_counter()
        cols = self.open_columns(name, man)
        self.io_add(read_s=time.perf_counter() - t0)
        cm = getattr(man, "capacity_map", None)
        return StoredDataset(
            name=man.name, columns=cols,
            counts=np.asarray(man.counts, np.int64),
            partitioner=decode_partitioner(man.partitioner),
            num_rows=int(man.num_rows), nbytes=int(man.nbytes),
            created_at=float(man.created_at),
            generation=int(man.generation),
            capacity_map=CapacityMap.of(cm) if cm is not None else None)

    def load_all(self) -> Dict[str, Any]:
        out = {}
        for name in self.dataset_names():
            ds = self.load(name)
            if ds is not None:
                out[name] = ds
        return out

    # -- decision log (Autopilot) --------------------------------------------
    @property
    def decisions_path(self) -> str:
        return os.path.join(self.root, "decisions.log")

    def log_decision(self, record: Dict[str, Any]) -> None:
        """Append one decision record (single-write JSONL line).

        Rows are stamped with the writer's schema version
        (:data:`DECISIONS_SCHEMA_VERSION`) unless the caller set one;
        :meth:`decisions` treats missing versions as v1 (pre-versioning
        writers) and skips-but-reports rows from a future version."""
        record = dict(record)
        record.setdefault("version", DECISIONS_SCHEMA_VERSION)
        with open(self.decisions_path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def decisions(self) -> List[Dict[str, Any]]:
        """Parsed decisions.log rows this reader understands (versions ≤
        :data:`DECISIONS_SCHEMA_VERSION`; missing version ⇒ v1).  Rows
        from a future schema are skipped, counted in
        ``self.skipped_decisions`` and warned about once per load — a
        downgraded reader degrades instead of crashing."""
        out: List[Dict[str, Any]] = []
        skipped = 0
        try:
            with open(self.decisions_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue        # torn final line after a crash
                    try:
                        v = int(rec.get("version", 1))
                    except (TypeError, ValueError):
                        v = DECISIONS_SCHEMA_VERSION + 1   # unparseable
                    if v > DECISIONS_SCHEMA_VERSION:
                        skipped += 1
                        continue
                    out.append(rec)
        except OSError:
            pass
        self.skipped_decisions = skipped
        if skipped:
            warnings.warn(
                f"decisions.log: skipped {skipped} row(s) with schema "
                f"version > {DECISIONS_SCHEMA_VERSION} (written by a newer "
                "build); readable rows were loaded", RuntimeWarning,
                stacklevel=2)
        return out
