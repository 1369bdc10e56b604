"""The cluster tier of the torch port (DESIGN §14) against the reference.

Every case of ``tests/test_cluster.py`` runs here once per package: the
same numpy-seeded data goes into a ``repro`` cluster store and a
``repro_torch`` one (the device backend on CPU tensors, and where the case
touches storage also the host backend), each case's assertions hold in
both, and the port's observable results — directory JSON, placements,
move sets, byte accounting, generations, epochs, signals, why-records —
equal the reference's.

Cross-package cases: a cluster store written by either package reopens in
the other bit for bit (columns, counts, manifests) and the same data gives
byte-equal node parts, directory and manifest files; the same membership
change gives the same rebalance plan, bytes moved and linked, and new
directory; a crash before the epoch commit reopens under the old epoch in
both packages; replica reads after a node's directory is deleted are
bit-identical; a lost node gives the same Autopilot decision and
why-record; and a rebalance misses exactly the cached plans of the old
placement.  Every threaded wait is time-boxed.
"""

import gc
import json
import os
import shutil
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.cluster as jcluster  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.service as jsvc  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.service as tsvc  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.cluster.directory import EPOCH_POINTER  # noqa: E402
from repro.data.partition_store import PartitionStore as JStore  # noqa: E402
from repro_torch.api import Session as TSession  # noqa: E402
from repro_torch.cluster.directory import \
    EPOCH_POINTER as T_EPOCH_POINTER  # noqa: E402
from repro_torch.data.partition_store import \
    PartitionStore as TStore  # noqa: E402

M = 8
NODES = ("alpha", "beta")

REF = SimpleNamespace(name="ref", Store=JStore, Session=JSession,
                      cluster=jcluster, svc=jsvc, obs=jobs,
                      epoch_pointer=EPOCH_POINTER)
PORT = SimpleNamespace(name="port", Store=TStore, Session=TSession,
                       cluster=tcluster, svc=tsvc, obs=tobs,
                       epoch_pointer=T_EPOCH_POINTER)

#: the port's store kinds on the CPU: the device backend on CPU tensors
#: (the kernels' plain twins) and the numpy backend
KINDS = {"device": dict(backend="device", device="cpu"),
         "host": dict(backend="host", device="cpu")}


def _kw(pk, kind):
    return {} if pk is REF else dict(KINDS[kind])


def _store(pk, root, kind="device", nodes=NODES, replication=2,
           num_workers=M, **kw):
    return pk.Store(root=str(root), num_workers=num_workers,
                    cluster=pk.cluster.ClusterConfig(
                        nodes=nodes, replication=replication, **kw),
                    **_kw(pk, kind))


def _reopen(pk, root, kind="device", num_workers=M):
    return pk.Store(root=str(root), num_workers=num_workers, **_kw(pk, kind))


def _session(pk, root, kind="device", nodes=NODES, replication=2):
    return pk.Session(store_path=str(root), num_workers=M,
                      cluster=pk.cluster.ClusterConfig(
                          nodes=nodes, replication=replication),
                      **_kw(pk, kind))


def _data(rows=400, cols=3, seed=0):
    rng = np.random.default_rng(seed)
    return {f"c{i}": rng.standard_normal(rows).astype(np.float64)
            for i in range(cols)}


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _canonical(ds):
    return {k: np.asarray(v).copy() for k, v in sorted(ds.gather().items())}


def _layout(ds):
    """The padded columns, counts and generation of one dataset."""
    return ({k: _np(v).copy() for k, v in sorted(ds.columns.items())},
            np.asarray(ds.counts).copy(), int(ds.generation))


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_layout(a, b):
    _assert_same(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def _equal(a, b):
    """Structural equality over nested dicts/lists/tuples of numpy
    arrays and plain values."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b


def _both(case, tmp_path, kind="device"):
    """Run ``case(pk, root, kind)`` in each package; the port's result
    equals the reference's."""
    roots = (None, None) if tmp_path is None else \
        (tmp_path / "ref", tmp_path / "port")
    want = case(REF, roots[0], kind)
    got = case(PORT, roots[1], kind)
    assert _equal(got, want), (got, want)
    return got


def _drop_sample(self, nbytes, seconds):
    return None


@pytest.fixture
def pinned(monkeypatch):
    """The same calibration in both packages: the cost models keep their
    priors (no live throughput samples), as in ``test_torch_service``."""
    for svc in (jsvc, tsvc):
        for name in ("observe_shuffle", "observe_repartition", "observe_io"):
            monkeypatch.setattr(svc.WhatIfCostModel, name, _drop_sample)


# ---------------------------------------------------------------------------
# PartitionDirectory
# ---------------------------------------------------------------------------

def test_directory_build_is_deterministic_and_replicated():
    def case(pk, _root, _kind):
        PD = pk.cluster.PartitionDirectory
        a = PD.build(16, ("n0", "n1", "n2"), replication=2)
        b = PD.build(16, ("n0", "n1", "n2"), replication=2)
        assert a.to_json() == b.to_json()
        for p in range(16):
            reps = a.replicas_of(p)
            assert len(reps) == 2 and len(set(reps)) == 2
            assert a.node_of(p) == reps[0]
            assert all(r in ("n0", "n1", "n2") for r in reps)
        return a.to_json(), a.lookups
    _both(case, None)


def test_directory_replication_caps_at_node_count():
    def case(pk, _root, _kind):
        d = pk.cluster.PartitionDirectory.build(8, ("solo",), replication=3)
        assert all(d.replicas_of(p) == ("solo",) for p in range(8))
        return d.to_json()
    _both(case, None)


def test_consistent_hash_moves_minimally_on_node_add():
    def case(pk, _root, _kind):
        old = pk.cluster.PartitionDirectory.build(
            64, ("n0", "n1", "n2", "n3"), replication=1)
        new = old.with_nodes(("n0", "n1", "n2", "n3", "n4"))
        moved = old.diff(new)
        assert 0 < len(moved) < 32
        assert all(dst == "n4" for _, _, dst in moved)
        movedset = {p for p, _, _ in moved}
        for p in range(64):
            if p not in movedset:
                assert old.node_of(p) == new.node_of(p)
        return moved, old.replica_changes(new), new.to_json()
    _both(case, None)


def test_range_placement_is_contiguous():
    def case(pk, _root, _kind):
        d = pk.cluster.PartitionDirectory.build(
            8, ("n0", "n1"), strategy=pk.cluster.RANGE_PLACEMENT,
            replication=1)
        assert [d.node_of(p) for p in range(8)] == ["n0"] * 4 + ["n1"] * 4
        assert d.strategy == pk.cluster.RANGE_PLACEMENT
        return d.to_json()
    _both(case, None)


def test_directory_epoch_bumps_and_diff_guards():
    def case(pk, _root, _kind):
        d = pk.cluster.PartitionDirectory.build(8, NODES)
        assert d.epoch == 0
        d2 = d.with_nodes(("alpha", "beta", "gamma"))
        assert d2.epoch == 1
        with pytest.raises(ValueError) as e:
            d.diff(d.with_m(16))
        return d2.to_json(), str(e.value)
    _both(case, None)


def test_directory_publish_and_load_current(tmp_path):
    def case(pk, root, _kind):
        root.mkdir()
        PD = pk.cluster.PartitionDirectory
        d = PD.build(8, NODES, replication=2)
        d.publish(str(root))
        d2 = d.with_nodes(("alpha",))
        d2.publish(str(root))
        got = PD.load_current(str(root))
        assert got.epoch == 1 and got.nodes == ("alpha",)
        files = {f.name: f.read_bytes() for f in sorted(root.iterdir())}
        with open(root / pk.epoch_pointer, "w") as f:
            f.write("garbage")
        torn = PD.load_current(str(root))
        assert torn.epoch == 1 and torn.nodes == ("alpha",)
        return files, torn.to_json()
    _both(case, tmp_path)


# ---------------------------------------------------------------------------
# Multi-node store: persist, reopen, replica fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_cluster_store_reopen_bit_identical(tmp_path, kind):
    def case(pk, root, kind):
        store = _store(pk, root, kind)
        store.write("d", _data())
        before = _canonical(store.read("d"))
        assert store.is_cluster and store.placement_epoch == 0
        for node in NODES:
            assert os.path.isdir(root / "nodes" / node)
        del store
        re = _reopen(pk, root, kind)
        assert re.is_cluster and re.directory.nodes == NODES
        _assert_same(_canonical(re.read("d")), before)
        return before, _layout(re.read("d")), re.directory.to_json()
    _both(case, tmp_path, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_cluster_store_serves_from_replicas_after_node_loss(tmp_path, kind):
    def case(pk, root, kind):
        store = _store(pk, root, kind, replication=2)
        store.write("d", _data(seed=1))
        before = _canonical(store.read("d"))
        del store
        shutil.rmtree(root / "nodes" / "beta")
        re = _reopen(pk, root, kind)
        _assert_same(_canonical(re.read("d")), before)
        return before, _layout(re.read("d"))
    _both(case, tmp_path, kind)


def test_cluster_store_rejects_memory_budget(tmp_path):
    def case(pk, root, kind):
        with pytest.raises(ValueError, match="memory_budget_bytes") as e:
            pk.Store(root=str(root), num_workers=M,
                     cluster=pk.cluster.ClusterConfig(nodes=NODES),
                     memory_budget_bytes=1 << 20, **_kw(pk, kind))
        return str(e.value)
    _both(case, tmp_path)


# ---------------------------------------------------------------------------
# Incremental rebalancing
# ---------------------------------------------------------------------------

def _result(res):
    return (res.epoch, res.partitions_moved, res.bytes_moved,
            res.replica_bytes, res.bytes_linked, dict(res.generations))


def _plan(plan):
    return (plan.old_epoch, plan.directory.to_json(), plan.moved,
            plan.replica_changes, plan.datasets, plan.est_bytes_moved,
            plan.reason, None if plan.mesh is None else
            (plan.mesh.shape, plan.mesh.axes), plan.mesh_error,
            plan.explain())


@pytest.mark.parametrize("kind", KINDS)
def test_rebalance_moves_only_changed_partitions(tmp_path, kind):
    def case(pk, root, kind):
        store = _store(pk, root, kind, nodes=("n0", "n1", "n2", "n3"),
                       replication=1, num_workers=32)
        store.write("d", _data(rows=3200, seed=2))
        before = _canonical(store.read("d"))
        total = float(store.read("d").padded_bytes)
        plan = store.plan_rebalance(add_nodes=("n4",), reason="scale-out")
        assert 0 < plan.partitions_moved < 32
        res = store.rebalance(plan=plan)
        assert res.epoch == 1 and store.placement_epoch == 1
        assert res.bytes_moved <= plan.partitions_moved / 32 * total + 1e-9
        assert res.bytes_moved < total
        assert res.partitions_moved == plan.partitions_moved
        _assert_same(_canonical(store.read("d")), before)
        del store
        re = _reopen(pk, root, kind, num_workers=32)
        assert re.placement_epoch == 1 and "n4" in re.directory.nodes
        _assert_same(_canonical(re.read("d")), before)
        return _plan(plan), _result(res), total, _layout(re.read("d"))
    _both(case, tmp_path, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_rebalance_node_remove_serves_all_partitions(tmp_path, kind):
    def case(pk, root, kind):
        store = _store(pk, root, kind, nodes=("alpha", "beta", "gamma"),
                       replication=2)
        store.write("d", _data(seed=3))
        before = _canonical(store.read("d"))
        res = store.rebalance(remove_nodes=("beta",), reason="drain")
        assert res.epoch == 1
        assert store.directory.nodes == ("alpha", "gamma")
        del store
        shutil.rmtree(root / "nodes" / "beta")
        re = _reopen(pk, root, kind)
        _assert_same(_canonical(re.read("d")), before)
        return _result(res), _layout(re.read("d"))
    _both(case, tmp_path, kind)


def test_rebalance_stale_plan_rejected(tmp_path):
    def case(pk, root, kind):
        store = _store(pk, root, kind)
        store.write("d", _data())
        stale = store.plan_rebalance(add_nodes=("gamma",))
        store.rebalance(add_nodes=("delta",))
        with pytest.raises(ValueError, match="stale") as e:
            store.rebalance(plan=stale)
        return str(e.value), store.placement_epoch
    _both(case, tmp_path)


def test_rebalance_noop_membership_rejected(tmp_path):
    def case(pk, root, kind):
        store = _store(pk, root, kind)
        errors = []
        for kw in ({"nodes": NODES}, {"remove_nodes": NODES}):
            with pytest.raises(ValueError) as e:
                store.plan_rebalance(**kw)
            errors.append(str(e.value))
        return errors
    _both(case, tmp_path)


@pytest.mark.parametrize("kind", KINDS)
def test_rebalance_crash_before_epoch_commit_recovers(tmp_path, kind):
    def case(pk, root, kind):
        store = _store(pk, root, kind)
        store.write("d", _data(seed=4))
        store.write("e", _data(seed=5))
        before = {n: _canonical(store.read(n)) for n in ("d", "e")}
        plan = store.plan_rebalance(add_nodes=("gamma",),
                                    reason="crash-test")
        with pytest.raises(pk.cluster.RebalanceAborted) as e:
            store.rebalance(plan=plan, abort_after=1)
        del store
        shutil.rmtree(root / "nodes" / "gamma", ignore_errors=True)
        re = _reopen(pk, root, kind)
        assert re.placement_epoch == 0
        assert re.directory.nodes == NODES
        for n in ("d", "e"):
            _assert_same(_canonical(re.read(n)), before[n])
        return (str(e.value), {n: _layout(re.read(n)) for n in ("d", "e")},
                re.directory.to_json())
    _both(case, tmp_path, kind)


# ---------------------------------------------------------------------------
# MVCC: concurrent readers across the rebalance flip (sync-point race)
# ---------------------------------------------------------------------------

class _Freeze:
    def __init__(self):
        self.reached = threading.Event()
        self._go = threading.Event()
        self._armed = True

    def __call__(self):
        if not self._armed:
            return
        self._armed = False
        self.reached.set()
        assert self._go.wait(60), "race test deadlocked at sync point"

    def release(self):
        self._go.set()


def test_reader_pinned_across_rebalance_flip(tmp_path):
    def case(pk, root, kind):
        store = _store(pk, root, kind)
        store.write("d", _data(seed=6))
        baseline = _canonical(store.read("d"))
        pinned = store.read("d")
        gen0 = pinned.generation
        freeze = _Freeze()
        store.set_sync_point("install:pre_flip", freeze)
        err = []

        def _rebalance():
            try:
                store.rebalance(add_nodes=("gamma",))
            except BaseException as e:    # noqa: BLE001 — surfaced below
                err.append(e)

        t = threading.Thread(target=_rebalance)
        try:
            t.start()
            assert freeze.reached.wait(60)
            racer = store.read("d")
            assert racer.generation == gen0
            _assert_same(_canonical(racer), baseline)
            freeze.release()
            t.join(60)
            assert not t.is_alive() and not err, err
        finally:
            freeze.release()
            store.set_sync_point("install:pre_flip", None)
        assert store.read("d").generation > gen0
        _assert_same(_canonical(store.read("d")), baseline)
        assert pinned.generation == gen0
        _assert_same(_canonical(pinned), baseline)
        assert store.placement_epoch == 1
        return gen0, store.read("d").generation, baseline
    _both(case, tmp_path)


# ---------------------------------------------------------------------------
# Straggler reissue on the part-read path
# ---------------------------------------------------------------------------

def test_slow_node_reads_reissue_to_replicas(tmp_path):
    def case(pk, root, kind):
        store = _store(pk, root, kind, nodes=("alpha", "beta", "gamma"),
                       replication=3)
        store.write("d", _data(seed=7))
        before = _canonical(store.read("d"))
        del store
        re = _reopen(pk, root, kind)
        _assert_same(_canonical(re.read("d")), before)
        man = re.durable.load_manifest("d")
        want = re.durable.open_columns("d", man)
        health = re.health
        health.set_read_latency(
            lambda node: 1.0 if node == "beta" else 0.001)
        sigs = []
        for _ in range(4):
            cols = re.durable.open_columns("d", man)
            for k in want:
                np.testing.assert_array_equal(cols[k], want[k], err_msg=k)
            sigs.extend(health.signals())
        assert health.straggler_reissues > 0
        assert any(s.kind == "straggler" and s.node == "beta" for s in sigs)
        # the reopen's own reads feed the window with measured (not
        # injected) latencies, so only the injected slow node's verdict
        # and the assembled bits are compared across packages
        return ({(s.kind, s.node) for s in sigs if s.node == "beta"},
                {k: np.asarray(v) for k, v in want.items()})
    _both(case, tmp_path)


# ---------------------------------------------------------------------------
# Autopilot: health signals → priced rebalance decisions
# ---------------------------------------------------------------------------

def _decisions(store):
    """decisions.log rows without their wall-clock fields."""
    return [{k: v for k, v in row.items() if k != "repartition_wall_s"}
            for row in store.durable.decisions()]


def test_lost_node_triggers_autopilot_rebalance_decision(tmp_path, pinned):
    def case(pk, root, kind):
        sess = _session(pk, root, kind)
        store = sess.store
        store.write("d", _data(seed=8))
        before = _canonical(store.read("d"))
        ap = sess.autopilot(clock=pk.svc.LogicalClock(),
                            config=pk.svc.AutopilotConfig(cooldown_ticks=0))
        h = store.health
        for step in range(1, 5):
            h.heartbeat("alpha", step)
            h.tick(step)
        assert h.dead_nodes() == ["beta"]
        rep = ap.tick()
        applied = [a for a in rep.applied if a.kind == "rebalance"]
        assert len(applied) == 1
        a = applied[0]
        assert a.dataset == "*" and a.path == "rebalance"
        assert a.generation == 1
        assert store.placement_epoch == 1
        assert store.directory.nodes == ("alpha",)
        decs = store.durable.decisions()
        reb = [d for d in decs if d.get("kind") == "rebalance"]
        assert len(reb) == 1 and reb[0]["dataset"] == "*"
        whys = [r for d in decs if d.get("kind") == "why"
                for r in d["records"]]
        lost = [w for w in whys if w["action"] == "rebalance:node_lost"]
        assert len(lost) == 1 and lost[0]["accepted"]
        gate_names = [g["gate"] for g in lost[0]["gates"]]
        assert "mesh_replan" in gate_names and "surviving_nodes" in gate_names
        assert lost[0]["score"]["io_s"] >= 0
        out = (rep.why, _decisions(store), a.moved_bytes)
        del sess, store, ap
        shutil.rmtree(root / "nodes" / "beta")
        re = _reopen(pk, root, kind)
        _assert_same(_canonical(re.read("d")), before)
        return out
    _both(case, tmp_path)


def test_straggler_signal_prices_rebalance_with_worth_it_gate(tmp_path,
                                                              pinned):
    def case(pk, root, kind):
        sess = _session(pk, root, kind, nodes=("alpha", "beta", "gamma"),
                        replication=3)
        store = sess.store
        store.write("d", _data(seed=9))
        ap = sess.autopilot(clock=pk.svc.LogicalClock(),
                            config=pk.svc.AutopilotConfig(cooldown_ticks=0))
        store.health._raise("straggler", "beta",
                            {"latency_s": 1.0, "threshold_s": 0.002,
                             "excess_s": 1.0, "detections": 3.0})
        rep = ap.tick()
        assert not any(a.kind == "rebalance" for a in rep.applied)
        w = next(r for r in rep.why if r["action"] == "rebalance:straggler")
        assert not w["accepted"]
        verdicts = {g["gate"]: g["passed"] for g in w["gates"]}
        assert verdicts["worth_it"] is False \
            and verdicts["mesh_replan"] is True
        assert store.placement_epoch == 0
        return rep.why
    _both(case, tmp_path)


def test_lost_node_without_survivors_is_rejected(tmp_path, pinned):
    def case(pk, root, kind):
        sess = _session(pk, root, kind, nodes=("solo",), replication=1)
        store = sess.store
        store.write("d", _data(seed=10))
        ap = sess.autopilot(clock=pk.svc.LogicalClock(),
                            config=pk.svc.AutopilotConfig(cooldown_ticks=0))
        for step in range(1, 5):
            store.health.tick(step)
        rep = ap.tick()
        assert not rep.applied
        w = next(r for r in rep.why if r["action"] == "rebalance:node_lost")
        verdicts = {g["gate"]: g["passed"] for g in w["gates"]}
        assert verdicts["surviving_nodes"] is False
        assert store.placement_epoch == 0
        return rep.why
    _both(case, tmp_path)


# ---------------------------------------------------------------------------
# Observability + planner integration
# ---------------------------------------------------------------------------

CLUSTER_METRICS = ("cluster_epoch", "cluster_nodes",
                   "cluster_directory_lookups_total",
                   "cluster_rebalances_total",
                   "cluster_rebalance_bytes_moved_total",
                   "cluster_rebalance_partitions_moved_total",
                   "cluster_parts_written_total",
                   "cluster_epoch_bumps_total",
                   "cluster_heartbeat_misses_total",
                   "cluster_straggler_reissues_total",
                   "cluster_nodes_alive")


def test_cluster_metrics_and_rebalance_span(tmp_path):
    def case(pk, root, kind):
        gc.collect()      # drop earlier tests' stores off the registries
        pk.obs.clear_spans()
        pk.obs.enable("full")
        try:
            reg = pk.obs.MetricsRegistry()
            sess = pk.Session(store_path=str(root), num_workers=M,
                              cluster=pk.cluster.ClusterConfig(
                                  nodes=NODES, replication=2),
                              metrics=reg, **_kw(pk, kind))
            sess.store.write("d", _data(seed=11))
            res = sess.rebalance(add_nodes=("gamma",), reason="metrics-test")
            assert res.epoch == 1
            m = sess.metrics()["metrics"]
            for name in CLUSTER_METRICS:
                assert name in m, name
            assert m["cluster_epoch"]["samples"][0]["value"] == 1.0
            assert m["cluster_rebalances_total"]["samples"][0]["value"] \
                == 1.0
            assert m["cluster_nodes"]["samples"][0]["value"] == 3.0
            assert m["cluster_directory_lookups_total"]["samples"][0][
                "value"] > 0
            spans = {s.name for s in pk.obs.finished_spans()}
            assert "cluster.rebalance" in spans
            assert "cluster.persist" in spans
            reb = next(s for s in pk.obs.finished_spans()
                       if s.name == "cluster.rebalance")
            assert reb.args["epoch"] == 1
            assert "bytes_moved" in reb.args
            values = {n: m[n]["samples"][0]["value"]
                      for n in sorted(m) if n.startswith("cluster_")}
            return values, {k: v for k, v in reb.args.items()
                            if k != "wall_s"}
        finally:
            pk.obs.disable()
            pk.obs.clear_spans()
    _both(case, tmp_path)


def test_plan_cache_invalidated_by_placement_epoch(tmp_path):
    def case(pk, root, kind):
        sess = _session(pk, root, kind)
        tables = pk.svc.drift_tables(n_lineitem=600, n_orders=200,
                                     n_parts=50)
        for name in ("lineitem", "orders"):
            sess.store.write(name, tables[name])
        wl = pk.svc.q_orderkey()
        r1 = sess.run(wl)
        assert not r1.stats.plan_cache_hit
        r2 = sess.run(wl)
        assert r2.stats.plan_cache_hit
        sess.rebalance(add_nodes=("gamma",))
        r3 = sess.run(wl)
        assert not r3.stats.plan_cache_hit
        assert "placement: directory epoch 1" in r3.plan.explain()
        return ([r.plan.key.placement_epoch for r in (r1, r2, r3)],
                [ln for ln in r3.plan.explain().splitlines()
                 if "placement" in ln or "layout" in ln])
    _both(case, tmp_path)


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _keyed_candidate(core, dataset="k"):
    wl = core.Workload("w")
    ds = wl.scan(dataset)
    wl.partition(ds["key"])
    return core.enumerate_candidates(wl.graph, dataset)[0]


def _write_pair(pk, root, kind, core):
    """A round-robin dataset and a hash-partitioned one, seeded."""
    store = _store(pk, root, kind, nodes=("n0", "n1", "n2"),
                   replication=2, num_workers=16)
    store.write("d", _data(rows=900, seed=12))
    rng = np.random.default_rng(13)
    store.write("k", {"key": rng.integers(0, 500, 1200),
                      "v": rng.standard_normal(1200).astype(np.float32)},
                _keyed_candidate(core))
    return store


def _core(pk):
    if pk is REF:
        import repro.core as core
    else:
        import repro_torch.core as core
    return core


def _manifest_sans_times(path):
    man = json.loads(Path(path).read_text())
    man.pop("created_at")
    for entry in man["generation_log"]:
        entry.pop("created_at")
    return man


def _store_files(root):
    """Every file of a cluster store but the catalog, telemetry and the
    decision log: segments and pointers as bytes, manifests without their
    timestamps."""
    out = {}
    for f in sorted(Path(root).rglob("*")):
        rel = str(f.relative_to(root))
        if not f.is_file() or rel in ("catalog.json", "decisions.log") \
                or rel.startswith("telemetry"):
            continue
        out[rel] = _manifest_sans_times(f) if f.name.startswith(
            "manifest-") else f.read_bytes()
    return out


def _manifests(store):
    out = {}
    for name in sorted(store.datasets):
        man = dict(store.durable.load_manifest(name).__dict__)
        man.pop("created_at")
        man["generation_log"] = [{k: v for k, v in e.items()
                                  if k != "created_at"}
                                 for e in man["generation_log"]]
        out[name] = man
    return out


PAIRS = {"ref-to-port": (REF, PORT), "port-to-ref": (PORT, REF)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", PAIRS)
def test_cluster_store_crosses_packages(tmp_path, direction, kind):
    """A cluster store written by one package reopens in the other with
    bit-identical columns, counts, generations, manifests and placement."""
    writer, reader = PAIRS[direction]
    root = tmp_path / "store"
    w = _write_pair(writer, root, kind, _core(writer))
    want = {n: _layout(w.read(n)) for n in ("d", "k")}
    sigs = w.read("k").partitioner.signature_set()
    mans = _manifests(w)
    del w
    r = _reopen(reader, root, kind, num_workers=16)
    assert r.is_cluster and r.placement_epoch == 0
    assert r.directory.nodes == ("n0", "n1", "n2")
    for n in ("d", "k"):
        _assert_same_layout(_layout(r.read(n)), want[n])
    assert r.read("k").partitioner.signature_set() == sigs
    assert _manifests(r) == mans
    if reader is PORT and kind == "device":
        assert all(isinstance(v, torch.Tensor)
                   for v in r.read("k").columns.values())


@pytest.mark.parametrize("kind", KINDS)
def test_same_data_gives_byte_equal_cluster_files(tmp_path, kind):
    """The same writes give the same node parts byte for byte, the same
    directory, EPOCH and cluster.json, and manifests equal apart from
    their timestamps — then the same after one rebalance."""
    files = {}
    for pk in (REF, PORT):
        root = tmp_path / pk.name
        store = _write_pair(pk, root, kind, _core(pk))
        before = _store_files(root)
        store.rebalance(add_nodes=("n3",), reason="parity")
        files[pk.name] = (before, _store_files(root))
    for i in range(2):
        ref, port = files["ref"][i], files["port"][i]
        assert sorted(port) == sorted(ref)
        for rel in ref:
            assert port[rel] == ref[rel], rel
    assert any(rel.endswith(".seg") and "/n3/" in f"/{rel}"
               for rel in files["port"][1])


@pytest.mark.parametrize("kind", KINDS)
def test_rebalance_plan_and_byte_accounting_match_reference(tmp_path, kind):
    """For the same membership change: the move set, estimated and
    streamed bytes, hard-linked bytes, and the new directory JSON."""
    def case(pk, root, kind):
        store = _write_pair(pk, root, kind, _core(pk))
        plans, results = [], []
        for change in ({"add_nodes": ("n3",)}, {"remove_nodes": ("n0",)}):
            plan = store.plan_rebalance(reason="parity", **change)
            res = store.rebalance(plan=plan)
            plans.append(_plan(plan))
            results.append(_result(res))
        return (plans, results, store.durable.cluster_snapshot(),
                (root / "directory-000002.json").read_text(),
                (root / "EPOCH").read_text())
    _both(case, tmp_path, kind)


@pytest.mark.parametrize("direction", PAIRS)
def test_crash_before_commit_reopens_old_epoch_across_packages(tmp_path,
                                                               direction):
    """``abort_after=1`` in one package; the other reopens under the old
    epoch with the pre-crash bits, and its clean retry commits epoch 1."""
    crasher, reader = PAIRS[direction]
    root = tmp_path / "store"
    store = _write_pair(crasher, root, "device", _core(crasher))
    before = {n: _canonical(store.read(n)) for n in ("d", "k")}
    spilled = []
    with pytest.raises(crasher.cluster.RebalanceAborted):
        store.rebalance(add_nodes=("n3",), abort_after=1,
                        on_abort=lambda: spilled.append(store.placement_epoch))
    assert spilled == [0]
    del store
    shutil.rmtree(root / "nodes" / "n3", ignore_errors=True)
    re = _reopen(reader, root, "device", num_workers=16)
    assert re.placement_epoch == 0
    for n in ("d", "k"):
        _assert_same(_canonical(re.read(n)), before[n])
    res = re.rebalance(add_nodes=("n3",))
    assert res.epoch == 1
    again = _reopen(crasher, root, "device", num_workers=16)
    assert again.placement_epoch == 1
    for n in ("d", "k"):
        _assert_same(_canonical(again.read(n)), before[n])


@pytest.mark.parametrize("kind", KINDS)
def test_replica_reads_after_node_loss_match_reference(tmp_path, kind):
    """One store, written by the reference; a node's directory deleted;
    both packages reassemble the same bits from the survivors."""
    root = tmp_path / "store"
    w = _write_pair(REF, root, kind, _core(REF))
    want = {n: _canonical(w.read(n)) for n in ("d", "k")}
    del w
    shutil.rmtree(root / "nodes" / "n1")
    ref = _reopen(REF, root, kind, num_workers=16)
    port = _reopen(PORT, root, kind, num_workers=16)
    for n in ("d", "k"):
        _assert_same(_canonical(port.read(n)), want[n])
        _assert_same_layout(_layout(port.read(n)), _layout(ref.read(n)))
    assert port.durable.cluster_snapshot() == ref.durable.cluster_snapshot()


def test_lost_node_decision_matches_reference_through_shared_root(tmp_path,
                                                                  pinned):
    """Each package's Autopilot turns the same lost node into the same
    rebalance over the same data; each package then explains the other's
    decisions.log identically."""
    whys = {}
    for pk in (REF, PORT):
        sess = _session(pk, tmp_path / pk.name, nodes=("a", "b", "c"))
        sess.store.write("d", _data(seed=14))
        ap = sess.autopilot(clock=pk.svc.LogicalClock(),
                            config=pk.svc.AutopilotConfig(cooldown_ticks=0))
        for step in range(1, 5):
            for n in ("a", "c"):
                sess.store.health.heartbeat(n, step)
            sess.store.health.tick(step)
        rep = ap.tick()
        assert [a.kind for a in rep.applied] == ["rebalance"]
        whys[pk.name] = (rep.why, _decisions(sess.store),
                         sess.directory.to_json())
    assert whys["port"] == whys["ref"]
    for pk, other in ((REF, PORT), (PORT, REF)):
        fresh = pk.Session(store_path=str(tmp_path / other.name),
                           **_kw(pk, "device"))
        assert fresh.explain_decisions() == whys["ref"][0]


def test_placement_epoch_misses_exactly_old_plans(tmp_path):
    """A rebalance misses the plans built against the old placement, in
    both packages alike, and a second run under the new one hits."""
    def case(pk, root, kind):
        sess = _session(pk, root, kind)
        tables = pk.svc.drift_tables(n_lineitem=600, n_orders=200,
                                     n_parts=50)
        for name in ("lineitem", "orders"):
            sess.store.write(name, tables[name])
        wl = pk.svc.q_orderkey()
        hits = [sess.run(wl).stats.plan_cache_hit for _ in range(2)]
        sess.rebalance(remove_nodes=("beta",))
        hits += [sess.run(wl).stats.plan_cache_hit for _ in range(2)]
        assert hits == [False, True, False, True]
        st = sess.plan_cache_stats()
        return hits, st["hits"], st["misses"], sess.store.placement_epoch
    _both(case, tmp_path)
