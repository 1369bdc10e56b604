"""Dataset manifests — the crash-safe catalog of one dataset (DESIGN §10).

Each generation of a dataset is described by one immutable JSON manifest
(``manifest-<gen>.json``): partitioner identity (strategy + the Alg. 4
path-signature set), per-worker counts, per-column dtype/shape/byte-count
and segment file, and the generation log.  Publication is a two-step
atomic protocol:

1. segments + ``manifest-<gen>.json`` are fully written (temp + fsync +
   rename each);
2. the ``CURRENT`` pointer file is rewritten by temp-then-atomic-rename.

``CURRENT`` is the *only* mutable file, and :func:`load_current` validates
the generation it points at (manifest parses, every segment exists at its
exact byte count) before trusting it — falling back to the newest older
generation that validates.  A crash at any point therefore reopens to the
previous consistent generation, bit-identically.

Partitioners persist by *identity*, not code: Alg. 4
(:func:`~repro_torch.core.matching.partitioning_match`) compares path-signature
sets, so a :class:`RestoredPartitioner` carrying the stored set elides
consumer shuffles across process restarts exactly like the live
:class:`~repro_torch.core.partitioner.PartitionerCandidate` it was saved from.
It has no key graph, so it can *match* but not *dispatch* — re-keying a
restored dataset requires a live candidate from a consumer IR.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import quote

import numpy as np
import torch

from ...core.partitioner import PartitionerCandidate
from ...core.sharding_bridge import ShardedColumn
from .segments import fsync_dir, segment_valid

__all__ = ["Manifest", "RestoredPartitioner", "encode_partitioner",
           "decode_partitioner", "gen_dirname", "manifest_filename",
           "segment_filename", "column_meta", "publish_manifest",
           "load_manifest", "load_current", "list_generations",
           "atomic_write_text", "MANIFEST_FORMAT"]

MANIFEST_FORMAT = 1
CURRENT = "CURRENT"
_MANIFEST_RE = re.compile(r"^manifest-(\d{6})\.json$")


# ---------------------------------------------------------------------------
# Restored partitioners
# ---------------------------------------------------------------------------

@dataclass
class RestoredPartitioner(PartitionerCandidate):
    """A partitioner identity reloaded from a manifest: matchable by its
    persisted signature set (Alg. 4), but with no key graph to execute."""
    stored_signature_set: Tuple[str, ...] = ()

    def signature_set(self) -> Tuple[str, ...]:
        return tuple(self.stored_signature_set) or (self.strategy,)

    def key_fn(self):
        raise ValueError(
            "restored partitioner (loaded from a store manifest) has no key "
            "graph; repartition with a live candidate from a consumer IR")


def encode_partitioner(p: Optional[PartitionerCandidate]
                       ) -> Optional[Dict[str, Any]]:
    if p is None:
        return None
    return {"strategy": p.strategy,
            "signature_set": list(p.signature_set()),
            "source_dataset": p.source_dataset}


def decode_partitioner(d: Optional[Dict[str, Any]]
                       ) -> Optional[PartitionerCandidate]:
    if d is None:
        return None
    return RestoredPartitioner(
        graph=None, strategy=d.get("strategy", "hash"),
        source_dataset=d.get("source_dataset", ""),
        stored_signature_set=tuple(d.get("signature_set", ())))


# ---------------------------------------------------------------------------
# Manifest artifact
# ---------------------------------------------------------------------------

def gen_dirname(generation: int) -> str:
    return f"gen-{generation:06d}"


def segment_filename(column: str) -> str:
    """Filesystem-safe segment name for a column key (separators and other
    unsafe characters percent-encoded, so a key like ``"user/id"`` can
    neither crash the write nor escape the generation directory)."""
    return f"{quote(column, safe='._@+-')}.seg"


def manifest_filename(generation: int) -> str:
    return f"manifest-{generation:06d}.json"


def column_meta(v) -> Tuple[np.dtype, Tuple[int, ...], int]:
    """numpy dtype, shape and byte count of a column, read from its
    metadata: a device tensor, or a column placed on a mesh, is neither
    copied nor synchronized to learn them (torch → numpy dtypes as
    ``Tensor.numpy()`` maps them)."""
    if isinstance(v, (torch.Tensor, ShardedColumn)):
        dt = torch.empty(0, dtype=v.dtype).numpy().dtype
        return dt, tuple(v.shape), v.numel() * v.element_size()
    a = np.asarray(v)                  # ndarray or memmap: no copy
    return a.dtype, tuple(a.shape), int(a.nbytes)


@dataclass
class Manifest:
    """Everything needed to reopen one generation without the writer."""
    name: str
    generation: int
    num_workers: int
    capacity: int
    num_rows: int
    nbytes: int
    counts: List[int]
    partitioner: Optional[Dict[str, Any]]
    columns: Dict[str, Dict[str, Any]]   # name → {dtype, shape, nbytes, file}
    created_at: float = 0.0
    format: int = MANIFEST_FORMAT
    generation_log: List[Dict[str, Any]] = field(default_factory=list)
    #: per-partition slot capacities of a bucketed (CapacityMap) layout;
    #: None ⇒ uniform ``capacity``.  Offsets are derived (prefix sum), so
    #: older readers that drop this field still parse the manifest
    #: (from_json filters unknown keys) — format stays 1.
    capacity_map: Optional[List[int]] = None

    @classmethod
    def of_dataset(cls, ds, prev: Optional["Manifest"] = None) -> "Manifest":
        """Describe a StoredDataset (columns are recorded in the padded
        layout they already have; device columns by their metadata)."""
        columns: Dict[str, Dict[str, Any]] = {}
        gdir = gen_dirname(ds.generation)
        for k, v in ds.columns.items():
            dt, shape, nbytes = column_meta(v)
            columns[k] = {"dtype": dt.str, "shape": list(shape),
                          "nbytes": int(nbytes),
                          "file": f"{gdir}/{segment_filename(k)}"}
        log = list(prev.generation_log) if prev is not None else []
        log.append({"generation": int(ds.generation),
                    "rows": int(ds.num_rows),
                    "partitioner": (ds.partitioner.signature()
                                    if ds.partitioner is not None else ""),
                    "created_at": float(ds.created_at)})
        cm = getattr(ds, "capacity_map", None)
        return cls(name=ds.name, generation=int(ds.generation),
                   num_workers=int(ds.num_workers),
                   capacity=int(ds.capacity), num_rows=int(ds.num_rows),
                   nbytes=int(ds.nbytes),
                   counts=[int(c) for c in ds.counts],
                   partitioner=encode_partitioner(ds.partitioner),
                   columns=columns, created_at=float(ds.created_at),
                   generation_log=log,
                   capacity_map=([int(c) for c in cm.capacities]
                                 if cm is not None else None))

    def to_json(self) -> str:
        return json.dumps(self.__dict__, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        d = json.loads(text)
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    def validate(self, ds_dir: str) -> bool:
        """True iff every segment this manifest references exists at its
        exact byte count — the crash-recovery acceptance check.

        Cluster-sharded columns (``parts`` specs, DESIGN §14) validate by
        *coverage*, not completeness: every partition must be readable
        from at least one holding node's part, so losing any single node
        of a replicated placement never invalidates the generation."""
        if self.format > MANIFEST_FORMAT:
            return False
        for spec in self.columns.values():
            parts = spec.get("parts")
            if parts is None:
                if not segment_valid(os.path.join(ds_dir, spec["file"]),
                                     spec["nbytes"]):
                    return False
                continue
            covered = set()
            for part in parts:
                if segment_valid(os.path.join(ds_dir, part["file"]),
                                 part["nbytes"]):
                    covered.update(int(p) for p in part["partitions"])
            if not covered.issuperset(range(int(self.num_workers))):
                return False
        return True


# ---------------------------------------------------------------------------
# Atomic publication + recovery
# ---------------------------------------------------------------------------

def atomic_write_text(path: str, text: str) -> None:
    """write-temp → fsync → atomic-rename → fsync(dir): the publish
    primitive every mutable pointer in the store goes through."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def publish_manifest(ds_dir: str, manifest: Manifest) -> None:
    """Commit ``manifest``'s generation: write its immutable JSON, then
    flip CURRENT.  Callers must have fully written the segments first."""
    atomic_write_text(os.path.join(
        ds_dir, manifest_filename(manifest.generation)), manifest.to_json())
    atomic_write_text(os.path.join(ds_dir, CURRENT),
                      str(int(manifest.generation)))


def load_manifest(ds_dir: str, generation: int) -> Optional[Manifest]:
    try:
        with open(os.path.join(ds_dir, manifest_filename(generation))) as f:
            return Manifest.from_json(f.read())
    except (OSError, ValueError, TypeError, KeyError):
        return None


def list_generations(ds_dir: str) -> List[int]:
    """Generations with a manifest file on disk, ascending."""
    gens = []
    try:
        names = os.listdir(ds_dir)
    except OSError:
        return []
    for n in names:
        m = _MANIFEST_RE.match(n)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens)


def load_current(ds_dir: str) -> Optional[Manifest]:
    """The newest generation that *validates*, preferring the one CURRENT
    points at.  A truncated segment, torn manifest, or missing CURRENT all
    degrade to the most recent consistent generation (or None when the
    dataset directory holds nothing usable)."""
    candidates: List[int] = []
    try:
        with open(os.path.join(ds_dir, CURRENT)) as f:
            candidates.append(int(f.read().strip()))
    except (OSError, ValueError):
        pass
    for g in reversed(list_generations(ds_dir)):
        if g not in candidates:
            candidates.append(g)
    for g in candidates:
        m = load_manifest(ds_dir, g)
        if m is not None and m.validate(ds_dir):
            return m
    return None
