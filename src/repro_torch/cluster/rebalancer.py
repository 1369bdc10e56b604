"""Incremental Rebalancer — minimal-move placement changes (DESIGN §14).

When the node set changes (add, remove, loss) the Rebalancer:

1. **plans** — builds the next directory epoch and diffs it against the
   current one: the move set is exactly the partitions whose PRIMARY
   entry changed (consistent hashing keeps that near ``m/n`` for a
   single-node change), plus the elastic mesh replan
   (:mod:`repro_torch.runtime.elastic`) the new device count implies;
2. **applies** — for every dataset, republishes the current generation's
   rows under the new placement as a NEW generation through the store's
   existing atomic pointer flip (``_install``): unchanged (node,
   partition-set) parts are hard-linked (zero traffic), only changed
   parts stream to their new nodes.  Concurrent MVCC readers holding the
   previous generation keep a consistent view throughout, and the
   generation bump invalidates exactly the cached plans that compiled
   against the old placement;
3. **commits** — flips the EPOCH pointer LAST.  A crash mid-apply leaves
   some datasets republished and some not — every one individually
   consistent — under the OLD epoch; reads stay bit-identical because a
   manifest is self-describing (parts carry their own node paths).

Apply never contacts dead nodes: dataset rows come from the resident
in-memory generation (assembled from surviving replicas at attach), so
draining a lost node is the same code path as planned scale-in.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.tracer import span as _span
from ..runtime.elastic import MeshPlan, replan_mesh
from .directory import PartitionDirectory

__all__ = ["RebalancePlan", "RebalanceResult", "Rebalancer",
           "RebalanceAborted"]


class RebalanceAborted(RuntimeError):
    """Raised by the test-only ``abort_after`` hook to simulate a crash
    mid-rebalance (after N datasets republished, before the epoch flip)."""


@dataclass
class RebalancePlan:
    """One priced, appliable placement change."""
    old_epoch: int
    directory: PartitionDirectory          # the proposed next epoch
    moved: Tuple[Tuple[int, str, str], ...]  # (partition, old, new) primaries
    replica_changes: int
    datasets: Tuple[str, ...]
    est_bytes_moved: int                   # primary-move bytes, exact
    reason: str = ""
    mesh: Optional[MeshPlan] = None        # elastic replan for the new set
    mesh_error: str = ""                   # e.g. fewer devices than model axis

    @property
    def partitions_moved(self) -> int:
        return len(self.moved)

    def explain(self) -> str:
        frac = self.partitions_moved / max(self.directory.m, 1)
        lines = [
            f"rebalance epoch {self.old_epoch} -> {self.directory.epoch} "
            f"({self.reason or 'membership change'})",
            f"  nodes: {', '.join(self.directory.nodes)}",
            f"  moves: {self.partitions_moved}/{self.directory.m} "
            f"partitions ({frac:.0%}), ~{self.est_bytes_moved} bytes "
            f"primary + {self.replica_changes} replica holder changes",
        ]
        if self.mesh is not None:
            lines.append(f"  mesh: {self.mesh.shape} over {self.mesh.axes}")
        if self.mesh_error:
            lines.append(f"  mesh: UNPLANNABLE ({self.mesh_error})")
        return "\n".join(lines)


@dataclass
class RebalanceResult:
    epoch: int
    partitions_moved: int
    bytes_moved: int
    replica_bytes: int
    bytes_linked: int
    wall_s: float
    generations: Dict[str, int] = field(default_factory=dict)


class Rebalancer:
    """Plans and applies incremental placement changes for one cluster
    :class:`~repro_torch.data.partition_store.PartitionStore`."""

    def __init__(self, store):
        if not getattr(store, "is_cluster", False):
            raise ValueError("rebalancer needs a cluster store "
                             "(PartitionStore(cluster=ClusterConfig(...)))")
        self.store = store

    # -- planning ------------------------------------------------------------
    def plan(self, *, add_nodes: Sequence[str] = (),
             remove_nodes: Sequence[str] = (),
             nodes: Optional[Sequence[str]] = None,
             reason: str = "") -> RebalancePlan:
        """Plan the move set for a membership change (either an explicit
        target ``nodes`` list, or the current set ± add/remove)."""
        cur = self.store.directory
        if nodes is None:
            removed = {str(n) for n in remove_nodes}
            new_nodes = [n for n in cur.nodes if n not in removed]
            new_nodes += [str(n) for n in add_nodes
                          if str(n) not in new_nodes]
        else:
            new_nodes = [str(n) for n in nodes]
        if not new_nodes:
            raise ValueError("cannot rebalance to an empty node set")
        if tuple(new_nodes) == cur.nodes:
            raise ValueError("node set unchanged — nothing to rebalance")
        new_dir = cur.with_nodes(new_nodes)
        moved = tuple(cur.diff(new_dir))
        names = tuple(sorted(self.store.datasets))
        est = self._estimate_moved_bytes(names, [p for p, _, _ in moved])
        cfg = self.store.cluster_config
        mesh, mesh_error = None, ""
        try:
            current_mesh = MeshPlan(
                (max(1, len(cur.nodes) * cfg.devices_per_node
                     // cfg.model_axis), cfg.model_axis),
                ("data", "model"))
            mesh = replan_mesh(current_mesh,
                               len(new_nodes) * cfg.devices_per_node)
        except ValueError as e:
            mesh_error = str(e)
        return RebalancePlan(
            old_epoch=cur.epoch, directory=new_dir, moved=moved,
            replica_changes=cur.replica_changes(new_dir),
            datasets=names, est_bytes_moved=est, reason=reason,
            mesh=mesh, mesh_error=mesh_error)

    def _estimate_moved_bytes(self, names: Sequence[str],
                              moved_partitions: Sequence[int]) -> int:
        """Exact padded bytes of the moved partitions' slots across every
        dataset (what the primary moves will stream)."""
        total = 0
        for name in names:
            try:
                ds = self.store.read(name)
            except KeyError:
                continue
            caps = np.asarray(ds.slot_capacities(), np.int64)
            slots = int(ds.total_slots)
            if slots <= 0:
                continue
            per_slot = ds.padded_bytes / slots
            total += int(sum(int(caps[p]) for p in moved_partitions)
                         * per_slot)
        return total

    # -- application ---------------------------------------------------------
    def apply(self, plan: RebalancePlan,
              abort_after: Optional[int] = None,
              on_abort=None) -> RebalanceResult:
        """Execute ``plan``: republish every dataset under the new
        placement (atomic per-dataset pointer flips), then commit the
        epoch.  ``abort_after=N`` (tests/smoke only) raises after N
        datasets, simulating a crash before the epoch commit;
        ``on_abort`` (a callable) runs at the crash point *while the
        ``cluster.rebalance`` span is still open* — the smoke uses it to
        spill the trace buffer exactly as a dying process would, so the
        in-flight span reaches the merged trace as ``incomplete``."""
        store, durable = self.store, self.store.durable
        if plan.old_epoch != store.directory.epoch:
            raise ValueError(
                f"plan is stale: built against epoch {plan.old_epoch}, "
                f"store is at {store.directory.epoch}")
        t0 = time.perf_counter()
        acct: Dict[str, float] = {}
        generations: Dict[str, int] = {}
        with _span("cluster.rebalance", "cluster",
                   epoch=plan.directory.epoch, reason=plan.reason,
                   partitions_moved=plan.partitions_moved,
                   datasets=len(plan.datasets)) as sp:
            done = 0
            for name in plan.datasets:
                try:
                    ds = store.read(name)
                except KeyError:
                    continue
                prev_man = durable.load_manifest(name, ds.generation)
                new = self._restamped(ds)
                store._install(
                    name, new,
                    persist=lambda d, pm=prev_man: durable.persist(
                        d, directory=plan.directory, prev_man=pm,
                        acct=acct))
                generations[name] = new.generation
                done += 1
                if abort_after is not None and done >= abort_after:
                    if on_abort is not None:
                        on_abort()
                    raise RebalanceAborted(
                        f"simulated crash after {done} dataset(s), "
                        "before epoch commit")
            # the commit point: everything above is invisible to a fresh
            # process until this pointer flips
            durable.publish_directory(plan.directory)
            health = getattr(store, "health", None)
            if health is not None:
                health.reset_nodes(plan.directory.nodes)
            durable.cluster_add(
                rebalances_total=1,
                rebalance_bytes_moved_total=acct.get("bytes_moved", 0),
                rebalance_replica_bytes_total=acct.get("replica_bytes", 0),
                rebalance_partitions_moved_total=plan.partitions_moved)
            wall = time.perf_counter() - t0
            sp.set(bytes_moved=int(acct.get("bytes_moved", 0)),
                   wall_s=wall)
        return RebalanceResult(
            epoch=plan.directory.epoch,
            partitions_moved=plan.partitions_moved,
            bytes_moved=int(acct.get("bytes_moved", 0)),
            replica_bytes=int(acct.get("replica_bytes", 0)),
            bytes_linked=int(durable.cluster_snapshot()
                             .get("rebalance_bytes_linked_total", 0)),
            wall_s=wall, generations=generations)

    @staticmethod
    def _restamped(ds):
        """The same rows/columns as ``ds``, as a fresh StoredDataset the
        store can install as the next generation (columns are shared —
        a rebalance changes placement, not data)."""
        from ..data.partition_store import StoredDataset
        return StoredDataset(
            name=ds.name, columns=dict(ds.columns), counts=ds.counts,
            partitioner=ds.partitioner, num_rows=ds.num_rows,
            nbytes=ds.nbytes, generation=ds.generation,
            capacity_map=ds.capacity_map)
