"""Multi-node durable store — segment shards across directories-as-nodes.

:class:`ClusterDurableStore` extends the single-host durable tier
(DESIGN §10) so that one dataset generation's segment files are sharded
across a set of :class:`Node` roots according to the
:class:`~repro_torch.cluster.directory.PartitionDirectory`::

    root/
      catalog.json                  # store identity (unchanged)
      cluster.json                  # node names, strategy, replication
      directory-000003.json         # immutable placement epochs
      EPOCH                         # pointer — current placement epoch
      datasets/<name>/
        CURRENT                     # unchanged commit protocol
        manifest-000007.json        # columns carry per-node "parts"
      nodes/<node>/datasets/<name>/
        gen-000007/<col>.seg        # this node's held partitions only

Each (node, column) *part* is one segment holding the concatenation of
the partitions that node holds (primary or replica), in ascending
partition order.  The manifest's column spec records every part — node,
partition list, primary sublist, relative path, byte count — so a
manifest is self-describing: a reader reassembles the full padded layout
from whatever holders are reachable WITHOUT consulting the directory,
which means an epoch flip can never strand a committed generation.

Nodes are plain directories, so the whole tier is testable on one host
and "killing a node" is removing its directory — exactly what the
three-process smoke on the card (``chip_smoke.py`` phase 11) does.  Reads
prefer a partition's primary holder and fall back to replicas when the
primary's part is missing (killed node) or straggles (p50-window detection via
:class:`~repro_torch.cluster.control.ClusterHealth` — the read is then
reissued against a replica, MapReduce-style speculative execution).

The commit protocol is unchanged from DESIGN §10 — parts → manifest →
CURRENT, each step atomic — with one addition: a *rebalance* publishes
each dataset under the new placement first and flips the EPOCH pointer
last, so a crash anywhere mid-rebalance reopens to individually
consistent datasets under the OLD committed epoch.

Device columns (torch tensors on CUDA) come to the host once per column
per persist, through ``.cpu().numpy()``; every node part is cut from
that host copy.  Reassembled columns are numpy in RAM; a device store
moves them to its device when it attaches them
(:meth:`~repro_torch.data.partition_store.PartitionStore._attach`).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.ir import to_numpy
from ..obs.tracer import span as _span
from ..data.storage.durable import DurableStore, _encode_name
from ..data.storage.manifest import (Manifest, atomic_write_text,
                                     gen_dirname, load_manifest,
                                     manifest_filename, publish_manifest,
                                     segment_filename)
from ..data.storage.segments import (fsync_dir, open_segment, segment_valid,
                                     write_segment)
from .directory import ClusterConfig, PartitionDirectory

__all__ = ["Node", "ClusterDurableStore"]

_GEN_RE = re.compile(r"^gen-(\d{6})$")
_GENERATION_LOG_CAP = 64


def _cluster_zero() -> Dict[str, float]:
    return {"rebalance_bytes_moved_total": 0,
            "rebalance_replica_bytes_total": 0,
            "rebalance_bytes_linked_total": 0,
            "rebalance_partitions_moved_total": 0,
            "rebalances_total": 0,
            "epoch_bumps_total": 0,
            "parts_written_total": 0,
            "parts_read_total": 0}


@dataclass(frozen=True)
class Node:
    """One storage node: a named directory root holding its share of
    every dataset's segment parts."""
    name: str
    root: str

    def dataset_dir(self, dataset: str) -> str:
        return os.path.join(self.root, "datasets", _encode_name(dataset))

    def gen_dir(self, dataset: str, generation: int) -> str:
        return os.path.join(self.dataset_dir(dataset),
                            gen_dirname(generation))


class ClusterDurableStore(DurableStore):
    """Durable tier sharded across directories-as-nodes."""

    is_cluster = True

    def __init__(self, root: str, *, num_workers: Optional[int] = None,
                 max_retired_generations: int = 2,
                 cluster: Optional[ClusterConfig] = None):
        super().__init__(root, num_workers=num_workers,
                         max_retired_generations=max_retired_generations)
        self.cluster = self._load_or_init_cluster(cluster)
        m = self.num_workers
        if m is None:
            raise ValueError("a cluster store needs a known worker count "
                             "(num_workers) to place partitions")
        self.directory = PartitionDirectory.load_current(self.root)
        if self.directory is None:
            self.directory = PartitionDirectory.build(
                m, self.cluster.nodes, strategy=self.cluster.strategy,
                replication=self.cluster.replication)
            self.directory.publish(self.root)
        #: set by the owning PartitionStore — heartbeat/straggler tracking
        self.health = None
        self.cluster_stats: Dict[str, float] = _cluster_zero()
        self._cluster_lock = threading.Lock()
        for node in self.nodes.values():
            os.makedirs(node.root, exist_ok=True)

    # -- cluster identity ----------------------------------------------------
    @property
    def cluster_path(self) -> str:
        return os.path.join(self.root, "cluster.json")

    def _load_or_init_cluster(self, cluster: Optional[ClusterConfig]
                              ) -> ClusterConfig:
        import json
        try:
            with open(self.cluster_path) as f:
                # on-disk config is authoritative: membership changes go
                # through the Rebalancer (directory epochs), never the ctor
                return ClusterConfig.from_json(json.load(f))
        except OSError:
            pass
        if cluster is None:
            raise ValueError(
                f"{self.root} has no cluster.json — pass cluster="
                "ClusterConfig(nodes=...) to create a cluster store")
        atomic_write_text(self.cluster_path, json.dumps(cluster.to_json(),
                                                        indent=1))
        return cluster

    @property
    def nodes(self) -> Dict[str, Node]:
        """Live membership (the current directory epoch's nodes)."""
        return {n: Node(n, os.path.join(self.root, "nodes", n))
                for n in self.directory.nodes}

    def node_gen_dir(self, node: str, dataset: str, generation: int,
                     create: bool = False) -> str:
        d = os.path.join(self.root, "nodes", node, "datasets",
                         _encode_name(dataset), gen_dirname(generation))
        if create:
            os.makedirs(d, exist_ok=True)
        return d

    def cluster_add(self, **deltas: float) -> None:
        with self._cluster_lock:
            for k, v in deltas.items():
                self.cluster_stats[k] = self.cluster_stats.get(k, 0) + v

    def cluster_snapshot(self) -> Dict[str, float]:
        with self._cluster_lock:
            return dict(self.cluster_stats)

    def publish_directory(self, directory: PartitionDirectory) -> None:
        """Commit a new placement epoch (the rebalance commit point)."""
        directory.publish(self.root)
        self.directory = directory
        self.cluster_add(epoch_bumps_total=1)

    # -- write path (sharded parts) ------------------------------------------
    def persist(self, ds, publish_current: bool = True, *,
                directory: Optional[PartitionDirectory] = None,
                prev_man: Optional[Manifest] = None,
                acct: Optional[Dict[str, float]] = None) -> Manifest:
        """Durably publish one generation, sharding each column into
        per-node parts under ``directory`` (default: the current epoch).

        ``prev_man`` + ``acct`` is the incremental-rebalance path: parts
        whose (node, partition-list) is unchanged from ``prev_man`` are
        hard-linked instead of rewritten (zero cross-node traffic), and
        ``acct`` accumulates ``bytes_moved`` (partitions whose primary
        changed) / ``replica_bytes`` (new replica holders only)."""
        directory = directory or self.directory
        t0 = time.perf_counter()
        with _span("cluster.persist", "cluster", dataset=ds.name,
                   generation=ds.generation, epoch=directory.epoch) as sp:
            ds_dir = self.dataset_dir(ds.name, create=True)
            caps = np.asarray(ds.slot_capacities(), np.int64)
            offs = np.asarray(ds.slot_offsets(), np.int64)
            m = ds.num_workers
            holders: Dict[str, List[int]] = {n: [] for n in directory.nodes}
            for p in range(m):
                for nd in directory.replicas_of(p):
                    holders[nd].append(p)
            prev_parts, prev_holders = self._prev_placement(prev_man)
            columns: Dict[str, Dict[str, Any]] = {}
            written = 0
            d2h_s = 0.0
            touched_dirs = set()
            for col, v in sorted(ds.columns.items()):
                # a device column crosses to the host here, exactly once;
                # every node part below is cut from this copy
                t_col = time.perf_counter()
                a = np.ascontiguousarray(to_numpy(v))
                d2h_s += time.perf_counter() - t_col
                flat = a.reshape((-1,) + a.shape[2:]) \
                    if ds.capacity_map is None else a
                rowbytes = int(a.dtype.itemsize
                               * int(np.prod(flat.shape[1:],
                                             dtype=np.int64)))
                spec: Dict[str, Any] = {
                    "dtype": a.dtype.str, "shape": list(a.shape),
                    "nbytes": int(a.nbytes), "parts": []}
                for node in directory.nodes:
                    ps = holders[node]
                    if not ps:
                        continue
                    ndir = self.node_gen_dir(node, ds.name, ds.generation,
                                             create=True)
                    path = os.path.join(ndir, segment_filename(col))
                    rel = os.path.relpath(path, ds_dir)
                    part_nbytes = int(sum(int(caps[p]) for p in ps)
                                      * rowbytes)
                    reused = False
                    prev = prev_parts.get((col, node))
                    if (prev is not None
                            and [int(p) for p in prev.get("partitions", ())]
                            == ps
                            and int(prev.get("nbytes", -1)) == part_nbytes):
                        src = os.path.join(ds_dir, prev["file"])
                        if segment_valid(src, part_nbytes):
                            reused = self._reuse_segment(src, path)
                    if reused:
                        self.cluster_add(
                            rebalance_bytes_linked_total=part_nbytes)
                    else:
                        chunk = np.concatenate(
                            [flat[offs[p]:offs[p] + int(caps[p])]
                             for p in ps]) if ps else flat[:0]
                        written += write_segment(path, chunk)
                        self.io_add(segments_written=1)
                        self.cluster_add(parts_written_total=1)
                    touched_dirs.add(ndir)
                    spec["parts"].append({
                        "node": node, "partitions": list(ps),
                        "primary": [p for p in ps
                                    if directory.replica_sets[p][0] == node],
                        "file": rel, "nbytes": part_nbytes})
                if acct is not None and prev_holders:
                    self._account_moves(acct, holders, prev_holders,
                                        directory, caps, rowbytes)
                columns[col] = spec
            for d in sorted(touched_dirs):
                fsync_dir(d)
            if prev_man is None and ds.generation > 0:
                prev_man = load_manifest(ds_dir, ds.generation - 1)
            man = Manifest.of_dataset(ds, prev_man)
            man.generation_log = man.generation_log[-_GENERATION_LOG_CAP:]
            man.columns = columns
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
            sp.set(bytes=written, nodes=len(directory.nodes), d2h_s=d2h_s)
            return man

    @staticmethod
    def _prev_placement(prev_man: Optional[Manifest]
                        ) -> Tuple[Dict, Dict[int, set]]:
        """(col, node) → part spec, and partition → holder-node set, of
        the previous generation's placement (empty when fresh)."""
        prev_parts: Dict = {}
        prev_holders: Dict[int, set] = {}
        if prev_man is None:
            return prev_parts, prev_holders
        for col, spec in prev_man.columns.items():
            for part in spec.get("parts", ()):
                prev_parts[(col, part["node"])] = part
                for p in part["partitions"]:
                    prev_holders.setdefault(int(p), set()).add(part["node"])
        return prev_parts, prev_holders

    @staticmethod
    def _account_moves(acct, holders, prev_holders, directory, caps,
                       rowbytes) -> None:
        """Cross-node traffic this column: bytes of every (node, partition)
        pair that is a NEW holder.  Primary-ownership changes count as
        ``bytes_moved`` (the incremental-rebalance acceptance metric);
        new replica holders count separately as ``replica_bytes``."""
        for node, ps in holders.items():
            for p in ps:
                if node in prev_holders.get(p, ()):
                    continue
                b = int(caps[p]) * rowbytes
                if directory.replica_sets[p][0] == node:
                    acct["bytes_moved"] = acct.get("bytes_moved", 0) + b
                else:
                    acct["replica_bytes"] = acct.get("replica_bytes", 0) + b

    @staticmethod
    def _reuse_segment(src: str, dst: str) -> bool:
        """Reuse an unchanged part for the new generation: hard link
        (same node, zero bytes), falling back to a local copy."""
        try:
            if os.path.exists(dst):
                os.remove(dst)
            os.link(src, dst)
            return True
        except OSError:
            try:
                shutil.copyfile(src, dst)
                return True
            except OSError:
                return False

    def _gc(self, ds_dir: str, current_gen: int) -> None:
        super()._gc(ds_dir, current_gen)
        enc = os.path.basename(ds_dir)
        keep_from = current_gen - self.max_retired_generations
        nodes_root = os.path.join(self.root, "nodes")
        try:
            node_names = os.listdir(nodes_root)
        except OSError:
            return
        for node in node_names:
            nd = os.path.join(nodes_root, node, "datasets", enc)
            try:
                names = os.listdir(nd)
            except OSError:
                continue
            for n in names:
                mt = _GEN_RE.match(n)
                if mt and int(mt.group(1)) < keep_from:
                    shutil.rmtree(os.path.join(nd, n), ignore_errors=True)

    # -- read path (reassembly with replica fallback) ------------------------
    def open_columns(self, name: str, man: Manifest) -> Dict[str, np.ndarray]:
        ds_dir = self.dataset_dir(name)
        out: Dict[str, np.ndarray] = {}
        t0 = time.perf_counter()
        total = 0
        for col, spec in sorted(man.columns.items()):
            if "parts" not in spec:
                # pre-cluster generation (store grown into a cluster):
                # plain single-segment column
                out[col] = open_segment(os.path.join(ds_dir, spec["file"]),
                                        spec["dtype"],
                                        tuple(spec["shape"]))
                continue
            arr, nread = self._assemble_column(ds_dir, man, col, spec)
            out[col] = arr
            total += nread
        if total:
            self.io_add(bytes_read=total,
                        read_s=time.perf_counter() - t0)
        return out

    def _assemble_column(self, ds_dir: str, man: Manifest, col: str,
                         spec: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        """Reassemble one column's padded layout from its node parts.

        Two passes: (1) each partition from its PRIMARY holder, deferring
        reads the straggler detector flags; (2) any remaining partition
        from ANY holder whose part is readable — the replica-fallback /
        speculative-reissue path.  Raises when some partition has no
        readable holder at all (data loss beyond the replication factor).
        """
        shape = tuple(int(s) for s in spec["shape"])
        dtype = np.dtype(spec["dtype"])
        arr = np.zeros(shape, dtype)
        if arr.size == 0:
            return arr, 0
        m = int(man.num_workers)
        if man.capacity_map is not None:
            caps = np.asarray(man.capacity_map, np.int64)
            flat = arr
        else:
            caps = np.full(m, int(man.capacity), np.int64)
            flat = arr.reshape((m * int(man.capacity),) + shape[2:])
        offs = np.concatenate([[0], np.cumsum(caps)[:-1]])
        row_shape = flat.shape[1:]
        filled = caps == 0        # zero-capacity partitions hold no rows
        nread = 0
        for primary_pass in (True, False):
            if filled.all():
                break
            for part in spec["parts"]:
                want = part["primary"] if primary_pass else part["partitions"]
                need = [p for p in want if not filled[p]]
                if not need:
                    continue
                data = self._read_part(ds_dir, part, dtype, row_shape,
                                       defer_stragglers=primary_pass)
                if data is None:
                    continue
                nread += int(data.nbytes)
                off = 0
                local: Dict[int, int] = {}
                for p in part["partitions"]:
                    local[int(p)] = off
                    off += int(caps[p])
                for p in need:
                    lo = local[int(p)]
                    flat[offs[p]:offs[p] + caps[p]] = data[lo:lo + caps[p]]
                    filled[p] = True
        missing = np.flatnonzero(~filled)
        if missing.size:
            raise OSError(
                f"dataset {man.name!r} column {col!r}: partitions "
                f"{missing.tolist()} unreadable from every holding node "
                f"(replication={self.cluster.replication})")
        return arr, nread

    def _read_part(self, ds_dir: str, part: Dict[str, Any], dtype, row_shape,
                   defer_stragglers: bool) -> Optional[np.ndarray]:
        """Read one node part eagerly, feeding its latency to the
        straggler detector.  Returns None when the part is missing /
        truncated (killed node) or — on the primary pass — when the read
        straggled, so the caller reissues against a replica holder."""
        path = os.path.join(ds_dir, part["file"])
        if not segment_valid(path, part["nbytes"]):
            return None
        t0 = time.perf_counter()
        try:
            data = np.fromfile(path, dtype=dtype)
        except OSError:
            return None
        self.cluster_add(parts_read_total=1)
        h = self.health
        if h is not None:
            lat = h.observed_latency(part["node"],
                                     time.perf_counter() - t0)
            if h.record_read(part["node"], lat) and defer_stragglers:
                return None
        rowlen = int(np.prod(row_shape, dtype=np.int64)) if row_shape else 1
        if rowlen <= 0 or data.size % rowlen:
            return None            # torn part: replica pass will retry
        return data.reshape((-1,) + tuple(row_shape))
