"""PartitionDirectory — the partition→node placement service (DESIGN §14).

The directory is the cluster tier's single source of truth for *where*
each of a store's ``m`` logical partitions lives.  It is deliberately a
small, versioned, serializable value object — the shape Whiz
(arXiv:1703.10272) argues for: decoupling the data-organization service
(an explicit partition→location map) from compute is what makes
placement-aware optimization possible at cluster scale.

Two placement strategies:

* ``consistent-hash`` — nodes project virtual points onto a stable hash
  ring (sha1, never Python's randomized ``hash``); a partition is owned
  by the first node clockwise of its own ring point.  Adding or removing
  one node therefore moves only ~``m/n`` partitions — the property the
  incremental :class:`~repro_torch.cluster.rebalancer.Rebalancer` exploits.
* ``range`` — contiguous partition ranges per node (locality-friendly;
  more movement on membership change).

Every membership or shape change produces a NEW directory with
``epoch + 1`` — directories are immutable values, and the epoch is the
placement generation the planner pins into its PhysicalPlan cache key
(a rebalance bumps the epoch, which invalidates exactly the plans that
compiled against the old placement).

Replication-set metadata: each partition carries an ordered replica set
(primary first, ``replication`` distinct nodes total when the cluster is
large enough).  The multi-node store persists a partition's segments to
every holder, so the loss of any single node leaves every partition
readable from a survivor.

Durability follows the manifest idiom (DESIGN §10): immutable
``directory-<epoch>.json`` files plus an ``EPOCH`` pointer rewritten by
temp-then-atomic-rename; loading prefers the pointer and falls back to
the newest parseable epoch, so a crash mid-rebalance reopens to the last
committed placement.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..data.storage.manifest import atomic_write_text

__all__ = ["ClusterConfig", "PartitionDirectory", "CONSISTENT_HASH",
           "RANGE_PLACEMENT", "STRATEGIES", "EPOCH_POINTER"]

CONSISTENT_HASH = "consistent-hash"
RANGE_PLACEMENT = "range"
STRATEGIES = (CONSISTENT_HASH, RANGE_PLACEMENT)

EPOCH_POINTER = "EPOCH"
_DIRECTORY_RE = re.compile(r"^directory-(\d{6})\.json$")

#: virtual ring points per node — enough to keep the per-node partition
#: share within a few percent of uniform at the m values the repo uses
VIRTUAL_POINTS = 64


def _stable_hash(s: str) -> int:
    """64-bit hash stable across processes and Python versions (the ring
    must be identical for every process that opens the cluster)."""
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


def _directory_filename(epoch: int) -> str:
    return f"directory-{epoch:06d}.json"


@dataclass
class ClusterConfig:
    """Static cluster identity: node names, placement strategy,
    replication factor.  Persisted once as ``cluster.json`` next to the
    store catalog; the on-disk copy is authoritative on reopen (node-set
    changes go through the Rebalancer, never through the constructor)."""

    nodes: Tuple[str, ...]
    strategy: str = CONSISTENT_HASH
    replication: int = 2
    #: accelerator devices each node contributes — what the elastic mesh
    #: replan (runtime/elastic.py) converts a membership change into
    devices_per_node: int = 1
    #: model-parallel axis size the mesh replan must preserve
    model_axis: int = 1

    def __post_init__(self):
        self.nodes = tuple(str(n) for n in self.nodes)
        if not self.nodes:
            raise ValueError("cluster needs at least one node")
        if len(set(self.nodes)) != len(self.nodes):
            raise ValueError(f"duplicate node names: {self.nodes}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown placement strategy "
                             f"{self.strategy!r}; one of {STRATEGIES}")
        if int(self.replication) < 1:
            raise ValueError("replication factor must be >= 1")

    def to_json(self) -> Dict:
        return {"nodes": list(self.nodes), "strategy": self.strategy,
                "replication": int(self.replication),
                "devices_per_node": int(self.devices_per_node),
                "model_axis": int(self.model_axis)}

    @classmethod
    def from_json(cls, d: Dict) -> "ClusterConfig":
        return cls(nodes=tuple(d["nodes"]),
                   strategy=d.get("strategy", CONSISTENT_HASH),
                   replication=int(d.get("replication", 2)),
                   devices_per_node=int(d.get("devices_per_node", 1)),
                   model_axis=int(d.get("model_axis", 1)))


@dataclass
class PartitionDirectory:
    """One immutable placement epoch: partition id → ordered replica set
    (primary first).  ``lookups`` is the only mutable field — a plain
    observability counter (GIL-atomic ``+=``), excluded from equality."""

    m: int
    nodes: Tuple[str, ...]
    strategy: str
    replication: int
    epoch: int
    replica_sets: Tuple[Tuple[str, ...], ...]
    lookups: int = field(default=0, compare=False)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, m: int, nodes: Sequence[str], *,
              strategy: str = CONSISTENT_HASH, replication: int = 2,
              epoch: int = 0) -> "PartitionDirectory":
        nodes = tuple(str(n) for n in nodes)
        if not nodes:
            raise ValueError("cannot place partitions on zero nodes")
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown placement strategy {strategy!r}")
        r = min(int(replication), len(nodes))
        if strategy == CONSISTENT_HASH:
            sets = cls._consistent_hash_sets(int(m), nodes, r)
        else:
            sets = cls._range_sets(int(m), nodes, r)
        return cls(m=int(m), nodes=nodes, strategy=strategy,
                   replication=int(replication), epoch=int(epoch),
                   replica_sets=sets)

    @staticmethod
    def _consistent_hash_sets(m: int, nodes: Tuple[str, ...],
                              r: int) -> Tuple[Tuple[str, ...], ...]:
        ring: List[Tuple[int, str]] = sorted(
            (_stable_hash(f"{node}#{v}"), node)
            for node in nodes for v in range(VIRTUAL_POINTS))
        points = [h for h, _ in ring]
        sets: List[Tuple[str, ...]] = []
        for p in range(m):
            i = bisect.bisect_right(points, _stable_hash(f"partition-{p}"))
            chosen: List[str] = []
            for k in range(len(ring)):
                node = ring[(i + k) % len(ring)][1]
                if node not in chosen:
                    chosen.append(node)
                    if len(chosen) == r:
                        break
            sets.append(tuple(chosen))
        return tuple(sets)

    @staticmethod
    def _range_sets(m: int, nodes: Tuple[str, ...],
                    r: int) -> Tuple[Tuple[str, ...], ...]:
        n = len(nodes)
        sets: List[Tuple[str, ...]] = []
        for p in range(m):
            owner = min(p * n // max(m, 1), n - 1)
            sets.append(tuple(nodes[(owner + k) % n] for k in range(r)))
        return tuple(sets)

    # -- lookups (the router path) -------------------------------------------
    def node_of(self, partition: int) -> str:
        """Primary owner of ``partition`` (counts as a directory lookup)."""
        self.lookups += 1
        return self.replica_sets[partition][0]

    def replicas_of(self, partition: int) -> Tuple[str, ...]:
        """Ordered replica set of ``partition``, primary first."""
        self.lookups += 1
        return self.replica_sets[partition]

    def partitions_of(self, node: str) -> List[int]:
        """Partitions ``node`` owns as primary."""
        return [p for p in range(self.m) if self.replica_sets[p][0] == node]

    def holders_of(self, node: str) -> List[int]:
        """Partitions ``node`` holds at all (primary or replica)."""
        return [p for p in range(self.m) if node in self.replica_sets[p]]

    # -- membership / shape changes (each returns a NEW epoch) ----------------
    def with_nodes(self, nodes: Sequence[str]) -> "PartitionDirectory":
        return PartitionDirectory.build(
            self.m, nodes, strategy=self.strategy,
            replication=self.replication, epoch=self.epoch + 1)

    def with_m(self, m: int) -> "PartitionDirectory":
        return PartitionDirectory.build(
            m, self.nodes, strategy=self.strategy,
            replication=self.replication, epoch=self.epoch + 1)

    def diff(self, new: "PartitionDirectory"
             ) -> List[Tuple[int, str, str]]:
        """Partitions whose PRIMARY owner differs under ``new`` —
        ``[(partition, old_node, new_node)]``.  The incremental move set:
        everything else stays put."""
        if new.m != self.m:
            raise ValueError(f"diff across partition counts "
                            f"({self.m} vs {new.m}) is a re-shuffle, "
                            "not a rebalance")
        return [(p, self.replica_sets[p][0], new.replica_sets[p][0])
                for p in range(self.m)
                if self.replica_sets[p][0] != new.replica_sets[p][0]]

    def replica_changes(self, new: "PartitionDirectory") -> int:
        """(partition, node) holder pairs that are new under ``new`` but
        whose primary did NOT change — pure replica churn."""
        changes = 0
        for p in range(self.m):
            if self.replica_sets[p][0] != new.replica_sets[p][0]:
                continue
            changes += len(set(new.replica_sets[p])
                           - set(self.replica_sets[p]))
        return changes

    # -- serialization --------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "epoch": int(self.epoch), "m": int(self.m),
            "strategy": self.strategy, "replication": int(self.replication),
            "nodes": list(self.nodes),
            # explicit sets, not re-derived: a reopened process must see the
            # exact placement this epoch committed, even across algorithm
            # tweaks in future builds
            "replica_sets": [list(rs) for rs in self.replica_sets],
        }, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PartitionDirectory":
        d = json.loads(text)
        return cls(m=int(d["m"]), nodes=tuple(d["nodes"]),
                   strategy=d["strategy"],
                   replication=int(d["replication"]),
                   epoch=int(d["epoch"]),
                   replica_sets=tuple(tuple(rs)
                                      for rs in d["replica_sets"]))

    # -- durable publication (manifest idiom, DESIGN §10) ---------------------
    def publish(self, root: str) -> None:
        """Commit this epoch: immutable ``directory-<epoch>.json``, then
        flip the ``EPOCH`` pointer (the rebalance commit point)."""
        atomic_write_text(os.path.join(root, _directory_filename(self.epoch)),
                          self.to_json())
        atomic_write_text(os.path.join(root, EPOCH_POINTER),
                          str(int(self.epoch)))

    @classmethod
    def load_current(cls, root: str) -> Optional["PartitionDirectory"]:
        """Newest epoch that parses, preferring the one EPOCH points at —
        a crash between the epoch file and the pointer (or mid-rebalance,
        before either) degrades to the last committed placement."""
        candidates: List[int] = []
        try:
            with open(os.path.join(root, EPOCH_POINTER)) as f:
                candidates.append(int(f.read().strip()))
        except (OSError, ValueError):
            pass
        epochs = []
        try:
            for n in os.listdir(root):
                mt = _DIRECTORY_RE.match(n)
                if mt:
                    epochs.append(int(mt.group(1)))
        except OSError:
            return None
        for e in sorted(epochs, reverse=True):
            if e not in candidates:
                candidates.append(e)
        for e in candidates:
            try:
                with open(os.path.join(root, _directory_filename(e))) as f:
                    return cls.from_json(f.read())
            except (OSError, ValueError, KeyError):
                continue
        return None
