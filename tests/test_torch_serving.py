"""The serving frontend of the torch port (DESIGN §11) under concurrency,
on the CPU; ported from ``tests/test_serving_concurrency.py`` and
``tests/test_serving_races.py``.

One shared store, many client threads, layout generations flipping
underneath: every concurrent result must equal the same workload run
serially, and the serial baselines equal the reference's on the same
seeded tables.  Coalescing (one execution per identical queued request,
split by a generation flip, never for writes), admission and
backpressure, tenant budgets, UDF faults and namespaces, a background
Autopilot, the store's sync-point races, and the kernels' launch counters
under threads.  The device backend runs on CPU tensors (the kernels'
plain twins).  Every join and ``result()`` waits a bounded time.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lachesis  # noqa: E402
import lachesis_torch  # noqa: E402
import repro.service as jsvc  # noqa: E402
import repro_torch.data.device_repartition as dr  # noqa: E402
from repro.core.dsl import Workload as JWorkload  # noqa: E402
from repro_torch.core.dsl import Workload  # noqa: E402
from repro_torch.core.executor import StalePlanError  # noqa: E402
from repro_torch.core.partitioner import enumerate_candidates  # noqa: E402
from repro_torch.data.partition_store import PartitionStore  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hash_partition import hash_partition as hp  # noqa: E402
from repro_torch.service import (AdmissionError, LogicalClock,  # noqa: E402
                                 TenantBudgetError, aggregate_result,
                                 drift_tables)

WAIT = 120          # seconds any single wait may take before the case fails
BACKENDS = {"host": dict(backend="host"),
            "device": dict(backend="device", device="cpu")}


# ---------------------------------------------------------------------------
# read-only variants of the drift mix (no write node => coalescable)
# ---------------------------------------------------------------------------

def q_orderkey_ro(wl_cls=Workload):
    wl = wl_cls("q-orderkey-ro")
    li, od = wl.scan("lineitem"), wl.scan("orders")
    j = wl.join(li, od, left_key=li["orderkey"], right_key=od["orderkey"],
                tag="li_orders")
    wl.aggregate(j, key=j["odate"], reducer="sum")
    return wl


def q_partkey_ro(wl_cls=Workload):
    wl = wl_cls("q-partkey-ro")
    li, pt = wl.scan("lineitem"), wl.scan("part")
    j = wl.join(li, pt, left_key=li["partkey"], right_key=pt["partkey"],
                tag="li_part")
    wl.aggregate(j, key=j["size"], reducer="sum")
    return wl


TABLES = dict(n_lineitem=3000, n_orders=800, n_parts=200)


def _seed_session(backend="host", max_retired_generations=2, **kw):
    store = PartitionStore(num_workers=4,
                           max_retired_generations=max_retired_generations,
                           **BACKENDS[backend])
    sess = lachesis_torch.Session(store, **kw)
    for name, data in drift_tables(**TABLES).items():
        sess.write(name, data)
    return sess


def _expected(sess):
    """Serial baselines, held to the reference's on the same tables."""
    want = {"ok": aggregate_result(sess.run(q_orderkey_ro()).values,
                                   q_orderkey_ro()),
            "pk": aggregate_result(sess.run(q_partkey_ro()).values,
                                   q_partkey_ro())}
    ref = lachesis.Session(num_workers=4)
    for name, data in jsvc.drift_tables(**TABLES).items():
        ref.write(name, data)
    for key, q in (("ok", q_orderkey_ro), ("pk", q_partkey_ro)):
        wl = q(JWorkload)
        _assert_same(want[key], jsvc.aggregate_result(ref.run(wl).values,
                                                      wl))
    return want


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def _lineitem_candidates():
    ok = enumerate_candidates(q_orderkey_ro().graph, "lineitem")[0]
    pk = enumerate_candidates(q_partkey_ro().graph, "lineitem")[0]
    return [ok, pk]


def _join_all(threads):
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# ---------------------------------------------------------------------------
# 16 clients under background flips, bit-equal to serial
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sixteen_clients_bit_identical_under_background_flips(backend):
    sess = _seed_session(backend, max_retired_generations=16)
    want = _expected(sess)
    front = sess.serve(max_workers=16, max_queue=256)
    cands = _lineitem_candidates()
    stop = threading.Event()
    flips, errors = [], []

    def flipper():
        i = 0
        try:
            while not stop.is_set():
                new, _ = sess.store.repartition(sess.store.read("lineitem"),
                                                cands[i % 2], swap=True)
                flips.append((new.generation,
                              sess.store.write_log[-1].get("path")))
                i += 1
        except Exception as e:      # noqa: BLE001
            errors.append(("flipper", e))

    def client(cid):
        try:
            for j in range(4):
                ro = q_orderkey_ro() if (cid + j) % 2 else q_partkey_ro()
                key = "ok" if (cid + j) % 2 else "pk"
                res = front.run(ro, coalesce=bool(cid % 2), timeout=WAIT,
                                block=True)
                _assert_same(aggregate_result(res.values, ro), want[key])
        except Exception as e:      # noqa: BLE001
            errors.append((cid, e))

    flip_t = threading.Thread(target=flipper, daemon=True)
    flip_t.start()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(16)]
    for t in clients:
        t.start()
    _join_all(clients)
    stop.set()
    _join_all([flip_t])
    front.close()
    assert not errors, f"concurrent serves failed: {errors[:3]}"
    assert len(flips) >= 2, "flipper never flipped — stress was vacuous"
    if backend == "device":
        assert {p for _, p in flips} == {"d2d"}
    st = front.stats()
    assert st["failed"] == 0 and st["completed"] >= 16
    assert st["completed"] + st["coalesced"] == 64
    assert st["p99_ms"] >= st["p50_ms"] > 0


def test_serving_with_real_background_autopilot():
    sess = _seed_session("device", max_retired_generations=16)
    want = _expected(sess)
    ap = sess.autopilot(clock=LogicalClock())
    front = sess.serve(max_workers=8, max_queue=128)
    for _ in range(3):
        front.run(q_orderkey_ro(), timeout=WAIT, block=True)
    errors = []
    ap.start(period_s=0.02)
    try:
        def client(cid):
            try:
                for _ in range(4):
                    res = front.run(q_orderkey_ro(), coalesce=False,
                                    timeout=WAIT, block=True)
                    _assert_same(aggregate_result(res.values,
                                                  q_orderkey_ro()),
                                 want["ok"])
            except Exception as e:  # noqa: BLE001
                errors.append((cid, e))

        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in clients:
            t.start()
        _join_all(clients)
    finally:
        ap.stop(timeout=WAIT)
        front.close()
    assert not errors, f"serves failed under autopilot: {errors[:3]}"
    assert ap.optimizer.last_error is None
    applied = [d for r in ap.optimizer.reports for d in r.applied]
    assert applied, "autopilot never applied a decision — stress vacuous"
    assert {d.path for d in applied} == {"d2d"}
    assert front.stats()["failed"] == 0


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

def _gated(name, gate):
    wl = Workload(name)
    x = wl.scan("lineitem")
    wl.map(x, lambda c: (gate.wait(60), {"k": c["orderkey"]})[1],
           tag="gated")
    return wl


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_coalescing_shares_one_execution(backend):
    sess = _seed_session(backend)
    want = _expected(sess)["ok"]
    # one worker held on a gated filler keeps the coalescing leader queued
    # while the followers arrive
    front = sess.serve(max_workers=1, max_queue=64)
    gate = threading.Event()
    f = front.submit(_gated("filler", gate))
    wl = q_orderkey_ro()
    tickets = [front.submit(wl) for _ in range(12)]
    gate.set()
    f.result(WAIT)
    results = [t.result(WAIT) for t in tickets]
    assert len({id(t) for t in tickets}) == 1
    assert tickets[0].coalesced_with == 11
    for r in results:
        _assert_same(aggregate_result(r.values, wl), want)
    st = front.stats()
    assert st["coalesced"] == 11 and st["admitted"] == 2
    front.close()


def test_generation_flip_splits_coalescing_groups():
    sess = _seed_session("device")
    front = sess.serve(max_workers=4, max_queue=64)
    wl = q_orderkey_ro()
    t1 = front.submit(wl)
    t1.result(WAIT)
    sess.store.repartition(sess.store.read("lineitem"),
                           _lineitem_candidates()[0], swap=True)
    t2 = front.submit(wl)
    t2.result(WAIT)
    assert t1.key != t2.key
    _assert_same(aggregate_result(t2.result(WAIT).values, wl),
                 aggregate_result(t1.result(WAIT).values, wl))
    front.close()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_write_workloads_never_coalesce(backend):
    sess = _seed_session(backend)
    front = sess.serve(max_workers=4, max_queue=64)
    wl = Workload("writer")
    x = wl.scan("lineitem")
    agg = wl.aggregate(x, key=x["orderkey"], reducer="sum")
    wl.write(agg, "out")
    t1, t2 = front.submit(wl), front.submit(wl)
    t1.result(WAIT)
    t2.result(WAIT)
    assert t1 is not t2 and t1.key is None and t2.key is None
    assert front.stats()["coalesced"] == 0
    assert t1.latency_s > 0 and t2.latency_s > 0
    out = sess.read("out")
    assert out.num_rows == len(np.unique(drift_tables(**TABLES)
                                         ["lineitem"]["orderkey"]))
    if backend == "device":
        assert isinstance(out.columns["qty"], torch.Tensor)
    front.close()


# ---------------------------------------------------------------------------
# admission / backpressure
# ---------------------------------------------------------------------------

def test_admission_queue_full_rejects_then_recovers():
    sess = _seed_session("device")
    front = sess.serve(max_workers=1, max_queue=1, coalesce=False)
    gate = threading.Event()
    a = front.submit(_gated("slow-0", gate))     # running, parked
    b = front.submit(_gated("slow-1", gate))     # holds the waiting slot
    with pytest.raises(AdmissionError):
        front.submit(_gated("slow-2", gate))
    gate.set()
    a.result(WAIT)
    b.result(WAIT)
    front.submit(_gated("slow-3", gate)).result(WAIT)
    st = front.stats()
    assert st["rejected"] == 1 and st["failed"] == 0
    front.close()


def test_blocking_admission_waits_for_a_slot():
    sess = _seed_session("host")
    front = sess.serve(max_workers=1, max_queue=0, coalesce=False)
    gate = threading.Event()
    a = front.submit(_gated("slow-0", gate))
    with pytest.raises(AdmissionError):
        front.submit(_gated("slow-1", gate), block=True, timeout=0.05)
    threading.Timer(0.1, gate.set).start()
    front.submit(_gated("slow-2", gate), block=True,
                 timeout=WAIT).result(WAIT)
    a.result(WAIT)
    assert front.stats()["rejected"] == 1
    front.close()
    with pytest.raises(RuntimeError, match="closed"):
        front.submit(q_orderkey_ro())


def test_plan_cache_thrash_capacity_two(monkeypatch):
    """Capacity-2 planner and ShufflePlan caches under concurrent distinct
    workloads stay correct and bounded."""
    sess = _seed_session("device", plan_cache_capacity=2)
    want = _expected(sess)
    monkeypatch.setattr(dr, "_PLAN_CACHE_CAPACITY", 2)
    dr.clear_plan_cache()
    front = sess.serve(max_workers=8, max_queue=128)
    errors = []

    def client(cid):
        try:
            for j in range(3):
                ro = q_orderkey_ro() if (cid + j) % 2 else q_partkey_ro()
                key = "ok" if (cid + j) % 2 else "pk"
                res = front.run(ro, coalesce=False, timeout=WAIT, block=True)
                _assert_same(aggregate_result(res.values, ro), want[key])
        except Exception as e:      # noqa: BLE001
            errors.append((cid, e))

    clients = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    for t in clients:
        t.start()
    _join_all(clients)
    front.close()
    assert not errors, f"thrash failures: {errors[:3]}"
    st = sess.plan_cache_stats()
    assert st["size"] <= 2 and st["misses"] >= 1
    shuffle_plans = dr.plan_cache_stats()
    assert shuffle_plans["plans"] <= 2 and shuffle_plans["evictions"] >= 1
    dr.clear_plan_cache()


# ---------------------------------------------------------------------------
# tenancy
# ---------------------------------------------------------------------------

def _tenant_tables():
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, 40, 3000),
            "v": rng.integers(0, 100, 3000).astype(np.float64)}


def _tenant_query(tenant):
    wl = tenant.workload()
    x = wl.scan("t")
    wl.aggregate(x, key=x["k"], reducer="sum")
    return wl


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_tenant_budget_exhaustion_is_isolated(backend):
    sess = lachesis_torch.Session(num_workers=4, **BACKENDS[backend])
    front = sess.serve(max_workers=4, max_queue=32)
    data = _tenant_tables()
    alice = front.tenant("alice", memory_budget_bytes=1 << 16)
    bob = front.tenant("bob")
    alice.write("t", data)
    bob.write("t", data)
    assert alice.used_bytes() == bob.used_bytes() == \
        sess.store.namespace_bytes("alice::")
    want = aggregate_result(bob.run(_tenant_query(bob), timeout=WAIT).values,
                            _tenant_query(bob))
    with pytest.raises(TenantBudgetError):
        alice.write("big", {"x": np.zeros(1 << 16)})
    assert not any(n.endswith("big") for n in sess.store.datasets)
    got = aggregate_result(bob.run(_tenant_query(bob), timeout=WAIT).values,
                           _tenant_query(bob))
    _assert_same(got, want)
    alice.run(_tenant_query(alice), timeout=WAIT)
    front.close()


def test_tenant_bad_udf_fails_only_its_ticket():
    sess = lachesis_torch.Session(num_workers=4, device="cpu")
    front = sess.serve(max_workers=4, max_queue=32)
    data = _tenant_tables()
    alice, bob = front.tenant("alice"), front.tenant("bob")
    alice.write("t", data)
    bob.write("t", data)
    bad = alice.workload()
    x = bad.scan("t")
    bad.map(x, lambda c: {"z": c["no_such_column"]}, tag="bad")
    bad_t = alice.submit(bad)
    good_ts = [bob.submit(_tenant_query(bob), block=True, timeout=WAIT)
               for _ in range(6)]
    with pytest.raises(KeyError):
        bad_t.result(WAIT)
    for t in good_ts:
        t.result(WAIT)
    assert front.stats()["failed"] == 1
    front.close()


def test_tenant_namespaces_are_disjoint_in_shared_store():
    sess = lachesis_torch.Session(num_workers=4, device="cpu")
    front = sess.serve()
    a, b = front.tenant("alice"), front.tenant("bob")
    a.write("t", {"k": np.arange(10), "v": np.ones(10)})
    b.write("t", {"k": np.arange(20), "v": np.ones(20)})
    assert a.read("t").num_rows == 10 and b.read("t").num_rows == 20
    assert {"alice::t", "bob::t"} <= set(sess.store.datasets)
    assert a.used_bytes() != b.used_bytes()
    with pytest.raises(ValueError):
        front.tenant("bad::name")
    assert front.tenant("alice") is a
    front.close()


def test_frontend_metrics_report_serving_counters():
    sess = lachesis_torch.Session(num_workers=4, device="cpu")
    for name, data in drift_tables(**TABLES).items():
        sess.write(name, data)
    front = sess.serve(max_workers=2, max_queue=4)
    front.run(q_orderkey_ro(), timeout=WAIT)
    snap = front.metrics()
    names = {k for k in snap["metrics"]}
    assert "serving_completed" in names
    assert "serving_latency_seconds" in front.metrics_text()
    front.close()


# ---------------------------------------------------------------------------
# sync-point races (tests/test_serving_races.py)
# ---------------------------------------------------------------------------

def _data(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 500, n),
            "v": rng.integers(0, 100, n).astype(np.float64)}


def _candidate():
    wl = Workload("probe")
    x = wl.scan("d")
    wl.aggregate(x, key=x["k"], reducer="sum")
    return enumerate_candidates(wl.graph, "d")[0]


def _canonical(ds):
    flat = ds.gather()
    order = np.lexsort((flat["v"], flat["k"]))
    return {k: np.ascontiguousarray(np.asarray(v)[order])
            for k, v in flat.items()}


class _Freeze:
    """One-shot barrier: the hooked thread parks at the sync point until
    ``release()``; later hits pass straight through."""

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


def _repartition_in_thread(store):
    t = threading.Thread(target=lambda: store.repartition(
        store.read("d"), _candidate(), swap=True))
    t.start()
    return t


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_read_racing_install_pre_flip_sees_old_generation(backend):
    store = PartitionStore(num_workers=4, **BACKENDS[backend])
    store.write("d", _data())
    baseline = _canonical(store.read("d"))
    freeze = _Freeze()
    store.set_sync_point("install:pre_flip", freeze)
    try:
        t = _repartition_in_thread(store)
        assert freeze.reached.wait(60)
        reader = store.read("d")
        assert reader.generation == 0
        pre_bits = _canonical(reader)
        freeze.release()
        _join_all([t])
        assert store.read("d").generation == 1
        _assert_same(pre_bits, baseline)
        _assert_same(_canonical(reader), baseline)
        assert store.read("d", generation=0) is reader
        _assert_same(_canonical(store.read("d")), baseline)
    finally:
        store.set_sync_point("install:pre_flip", None)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_read_racing_install_post_flip_sees_new_generation(backend):
    store = PartitionStore(num_workers=4, **BACKENDS[backend])
    store.write("d", _data())
    baseline = _canonical(store.read("d"))
    freeze = _Freeze()
    store.set_sync_point("install:post_flip", freeze)
    try:
        t = _repartition_in_thread(store)
        assert freeze.reached.wait(60)
        reader = store.read("d")
        assert reader.generation == 1
        _assert_same(_canonical(reader), baseline)
        freeze.release()
        _join_all([t])
    finally:
        store.set_sync_point("install:post_flip", None)


def test_pinned_read_is_atomic_across_flip():
    store = PartitionStore(num_workers=4, backend="host")
    store.write("d", _data())
    gen0 = store.read("d", generation=0)
    store.repartition(store.read("d"), _candidate(), swap=True)
    assert gen0.generation == 0
    assert store.read("d", generation=0) is gen0
    assert store.read("d", generation=1) is not gen0


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_gather_racing_spill_mid_column_swap(tmp_path, backend):
    store = PartitionStore(num_workers=4, root=str(tmp_path / "store"),
                           **BACKENDS[backend])
    store.write("d", _data())
    store.flush()
    baseline = _canonical(store.read("d"))
    hits = []

    class SecondColumnFreeze(_Freeze):
        def __call__(self):
            hits.append(1)
            if len(hits) == 2:
                super().__call__()

    freeze = SecondColumnFreeze()
    store.set_sync_point("spill:column", freeze)
    try:
        t = threading.Thread(target=lambda: store.spill("d"))
        t.start()
        assert freeze.reached.wait(60)
        ds = store.datasets["d"]     # no read(): it would prefetch
        kinds = {k: isinstance(v, np.memmap) for k, v in ds.columns.items()}
        assert sorted(kinds.values()) == [False, True], kinds
        _assert_same(_canonical(ds), baseline)
        freeze.release()
        _join_all([t])
        assert store.is_spilled("d")
        _assert_same(_canonical(store.read("d")), baseline)
    finally:
        store.set_sync_point("spill:column", None)


def test_gather_racing_prefetch_page_in(tmp_path):
    store = PartitionStore(num_workers=4, backend="host",
                           root=str(tmp_path / "store"))
    store.write("d", _data())
    store.flush()
    assert store.spill("d")
    baseline = _canonical(store.read("d"))
    freeze = _Freeze()
    store.set_sync_point("prefetch:pre_swap", freeze)
    try:
        t = threading.Thread(target=lambda: store.prefetch("d"))
        t.start()
        assert freeze.reached.wait(60)
        ds = store.read("d")
        assert ds.spilled
        _assert_same(_canonical(ds), baseline)
        freeze.release()
        _join_all([t])
        assert not store.read("d").spilled
        _assert_same(_canonical(store.read("d")), baseline)
    finally:
        store.set_sync_point("prefetch:pre_swap", None)


def test_spill_prefetch_same_name_serialize_without_deadlock(tmp_path):
    store = PartitionStore(num_workers=4, backend="host",
                           root=str(tmp_path / "store"))
    store.write("d", _data())
    store.flush()
    baseline = _canonical(store.read("d"))
    errors = []

    def storm(op):
        try:
            for _ in range(8):
                op("d")
                _assert_same(_canonical(store.read("d")), baseline)
        except Exception as e:      # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=storm, args=(op,))
               for op in (store.spill, store.prefetch) * 3]
    for t in threads:
        t.start()
    _join_all(threads)
    assert not errors, f"storm failed: {errors[:2]}"
    _assert_same(_canonical(store.read("d")), baseline)


def test_stale_plan_fails_before_any_step_then_replans():
    sess = lachesis_torch.Session(num_workers=4, device="cpu")
    sess.write("d", _data())
    wl = Workload("q")
    x = wl.scan("d")
    wl.aggregate(x, key=x["k"], reducer="sum")
    plan, hit = sess.planner.physical(wl, "host")
    assert not hit
    sess.store.repartition(sess.store.read("d"), _candidate(), swap=True)
    with pytest.raises(StalePlanError):
        sess.executor.execute(plan)
    res = sess.run(wl)
    assert res.stats.shuffles_elided == 1
    agg = max(n for n, nd in wl.graph.nodes.items() if nd.kind == "aggregate")
    assert res.values[agg] is not None


def test_install_blocked_at_flip_does_not_block_other_datasets():
    store = PartitionStore(num_workers=4, backend="host")
    store.write("d", _data(seed=0))
    store.write("e", _data(seed=1))
    base_e = _canonical(store.read("e"))
    freeze = _Freeze()
    store.set_sync_point("install:pre_flip", freeze)
    try:
        t = _repartition_in_thread(store)
        assert freeze.reached.wait(60)
        _assert_same(_canonical(store.read("e")), base_e)
        store.set_sync_point("install:pre_flip", None)
        store.write("e", _data(seed=2))
        assert store.read("e").generation == 1
        freeze.release()
        _join_all([t])
        assert store.read("d").generation == 1
    finally:
        store.set_sync_point("install:pre_flip", None)


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------

class _YieldingTable(dict):
    """A counter table that hands the interpreter to another thread between
    the read and the write of ``table[key] += 1``: exactly where an
    unguarded increment loses counts."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counters_lose_no_count_across_threads():
    """The wrappers count launches through one lock; a plain ``+= 1`` from
    16 threads loses counts here (the frontend's workers launch the hash
    kernels concurrently)."""
    table = _YieldingTable(k=0, other=0)
    n, threads = 500, 16
    barrier = threading.Barrier(threads)

    def bump():
        barrier.wait(timeout=WAIT)
        for _ in range(n):
            _build.count_launch(table, "k")

    ts = [threading.Thread(target=bump) for _ in range(threads)]
    for t in ts:
        t.start()
    _join_all(ts)
    assert table == {"k": n * threads, "other": 0}
    _build.reset_counts(table)
    assert table == {"k": 0, "other": 0}
    saved = dict(hp.LAUNCHES), dict(hp.SCATTER_ROUTES)
    try:
        hp.LAUNCHES["scatter_perm"] = 3
        hp.SCATTER_ROUTES["single_pass"] = 2
        hp.reset_launches()
        assert set(hp.LAUNCHES.values()) == {0}
        assert set(hp.SCATTER_ROUTES.values()) == {0}
    finally:
        hp.LAUNCHES.update(saved[0])
        hp.SCATTER_ROUTES.update(saved[1])
