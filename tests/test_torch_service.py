"""The Autopilot service of the torch port (DESIGN §8, §12) against the
reference, on the CPU.

The same seeded inputs go through ``repro.service`` and
``repro_torch.service``: the drift scenario's decisions, generations,
why-records and aggregates; the what-if ``score()`` of one history; the
Observer's records and auto-compaction; the skew actions (salt, rebucket,
unsalt, mirroring ``tests/test_skew_adaptive.py``); the store methods the
service calls (``rebucket``, ``namespace_bytes``, ``stored_partitioners``,
``padding_waste``); and ``Session.autopilot`` / ``explain_decisions``
through a durable root, written by either package.

Decisions depend on wall-clock calibration, which differs run to run and
package to package.  The ``pinned`` fixture fixes it the same way in both
packages, test-locally: the cost models drop live throughput samples (a
case injects its own straight into the calibrations), and every logged
run latency is 1 s.  The reference's files are not changed.
"""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lachesis  # noqa: E402
import lachesis_torch  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.service as jsvc  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.service as tsvc  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.data.partition_store import PartitionStore as JStore  # noqa: E402
from repro_torch.api import Session as TSession  # noqa: E402
from repro_torch.data.partition_store import (PartitionStore,  # noqa: E402
                                              StoredDataset)

ORDERKEY_SIG = "scan/attr:orderkey/partition[hash]"
PARTKEY_SIG = "scan/attr:partkey/partition[hash]"

#: port store kinds: the numpy backend, and the device backend on CPU
#: tensors (the kernels' plain twins); the reference runs on its host
#: backend unless a case names its device backend
PORT_STORES = {"host": dict(backend="host"),
               "device": dict(backend="device", device="cpu")}


def _drop_sample(self, nbytes, seconds):
    return None


def _pin_latency(orig):
    def log_workload(self, workload, **kw):
        kw["latency"] = 1.0
        return orig(self, workload, **kw)
    return log_workload


@pytest.fixture
def pinned(monkeypatch):
    """The same calibration in both packages: no live throughput samples
    (cases inject theirs into ``*_cal`` directly) and a 1 s latency on
    every logged run (the greedy rule prices consumer latencies)."""
    for svc in (jsvc, tsvc):
        for name in ("observe_shuffle", "observe_repartition", "observe_io"):
            monkeypatch.setattr(svc.WhatIfCostModel, name, _drop_sample)
    for hist in (jcore.HistoryStore, tcore.HistoryStore):
        monkeypatch.setattr(hist, "log_workload",
                            _pin_latency(hist.log_workload))


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_arrays(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _same_layout(tds, jds, what=""):
    """Stored bits, counts, capacity map, partitioner and generation."""
    _same_arrays(tds.columns, jds.columns, what)
    np.testing.assert_array_equal(tds.counts, jds.counts)
    assert tds.generation == jds.generation, what
    assert tds.nbytes == jds.nbytes and tds.num_rows == jds.num_rows
    tsig = tds.partitioner.signature() if tds.partitioner else None
    jsig = jds.partitioner.signature() if jds.partitioner else None
    assert tsig == jsig, what
    tcm, jcm = tds.capacity_map, jds.capacity_map
    assert (tcm is None) == (jcm is None), what
    if tcm is not None:
        np.testing.assert_array_equal(tcm.capacities, jcm.capacities)
        np.testing.assert_array_equal(tcm.offsets, jcm.offsets)


def _applied(rep, with_path=True):
    return [(a.dataset, a.kind, a.path if with_path else None,
             int(a.generation), int(a.moved_bytes),
             a.decision.candidate.signature() if a.decision else None,
             dataclasses.asdict(a.score)) for a in rep.applied]


def _considered(rep):
    return [(d, sig, dataclasses.asdict(score))
            for d, sig, score in rep.considered]


def _same_tick(trep, jrep, with_path=True):
    assert trep.tick == jrep.tick and trep.now == jrep.now
    assert _considered(trep) == _considered(jrep)
    assert _applied(trep, with_path) == _applied(jrep, with_path)
    assert trep.why == jrep.why
    assert trep.compacted == jrep.compacted


def _summary(r):
    return (r.shuffles, r.elided, r.shuffle_bytes, r.device_repartitions)


# ---------------------------------------------------------------------------
# the drift scenario
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_backend,port_kw", [
    ("host", PORT_STORES["host"]), ("device", PORT_STORES["device"])],
    ids=["host", "device"])
def test_drift_scenario_matches_reference(pinned, ref_backend, port_kw):
    jrep = jsvc.run_drift_scenario(backend=ref_backend)
    trep = tsvc.run_drift_scenario(**port_kw)
    for t, j in ((trep.tick_a, jrep.tick_a), (trep.tick_b_mid,
                                              jrep.tick_b_mid),
                 (trep.tick_b, jrep.tick_b)):
        _same_tick(t, j)
    assert trep.lineitem_generations == jrep.lineitem_generations \
        == [0, 1, 2]
    assert trep.lineitem_partitioners == jrep.lineitem_partitioners
    assert trep.lineitem_partitioners[1:] == [ORDERKEY_SIG, PARTKEY_SIG]
    assert [_summary(r) for r in trep.phase_a + trep.phase_b] == \
        [_summary(r) for r in jrep.phase_a + jrep.phase_b]
    assert _summary(trep.post_a) == _summary(jrep.post_a) \
        and trep.post_a.elided == 2
    assert _summary(trep.post_b) == _summary(jrep.post_b) \
        and trep.post_b.elided == 2
    for f in ("result_pre_a", "result_post_a", "result_pre_b",
              "result_post_b"):
        _same_arrays(getattr(trep, f), getattr(jrep, f), f)
    _same_arrays(trep.result_pre_a, trep.result_post_a)
    _same_arrays(trep.result_pre_b, trep.result_post_b)
    for name in ("lineitem", "orders", "part"):
        _same_layout(trep.store.read(name), jrep.store.read(name), name)
    if ref_backend == "device":
        for tick in (trep.tick_a, trep.tick_b):
            assert {a.path for a in tick.applied} == {"d2d"}
        assert isinstance(trep.store.read("lineitem").columns["orderkey"],
                          torch.Tensor)
    assert trep.autopilot.history.total_runs() == \
        jrep.autopilot.history.total_runs() == 11
    assert trep.autopilot.explain() == jrep.autopilot.explain()


def test_drift_scenario_defaults_to_the_card():
    """A deliberate divergence: the port's drift scenario runs where
    ``Session`` does, on CUDA unless asked for the CPU; the reference's
    defaults to the host backend."""
    tp = inspect.signature(tsvc.run_drift_scenario).parameters
    jp = inspect.signature(jsvc.run_drift_scenario).parameters
    assert tp["backend"].default == "device" and tp["device"].default == \
        "cuda"
    assert jp["backend"].default == "host" and "device" not in jp
    assert list(tp)[2:] == list(jp)[1:]


# ---------------------------------------------------------------------------
# the what-if cost model
# ---------------------------------------------------------------------------

def _history(svc, core):
    hist = core.HistoryStore()
    wl_a, wl_b = svc.q_orderkey(), svc.q_partkey()
    for t in range(1, 7):
        hist.log_workload(wl_a if t % 3 else wl_b, timestamp=float(t),
                          latency=0.1 * t, input_bytes=1e6 * t,
                          padded_bytes=3e6, valid_bytes=2e6)
    return hist, wl_a, wl_b


@pytest.mark.parametrize("case", [
    dict(),
    dict(window_s=3.5),
    dict(durable=True, source_spilled=True),
    dict(current_padded_bytes=4e6, current_valid_bytes=2.5e6,
         candidate_padded_bytes=3e6, local=True),
], ids=["plain", "window", "durable", "padding-local"])
def test_score_of_one_history_matches_reference(case):
    scores = {}
    for pkg, svc, core in (("ref", jsvc, jcore), ("port", tsvc, tcore)):
        hist, wl_a, wl_b = _history(svc, core)
        cm = svc.WhatIfCostModel(default_bandwidth=2e9)
        cm.observe_shuffle(1e6, 0.01)
        cm.observe_repartition(3e6, 0.05)
        cm.observe_io(1e6, 0.002)
        ok = core.enumerate_candidates(wl_a.graph, "lineitem")[0]
        pk = core.enumerate_candidates(wl_b.graph, "lineitem")[0]
        scores[pkg] = [dataclasses.asdict(cm.score(
            "lineitem", 5e6, 8, c, cur, hist, now=7.0, **case))
            for c, cur in ((ok, None), (pk, ok), (ok, ok))]
        s = cm.score("lineitem", 5e6, 8, pk, None, hist, now=7.0, **case)
        scores[pkg].append((s.explain(1.5, 4.0), s.worth_it(1.5, 4.0),
                            s.net_s, s.apply_cost_s))
    assert scores["port"] == scores["ref"]


def test_cost_model_priors_and_calibration_match_reference():
    got = []
    for svc in (jsvc, tsvc):
        cm = svc.WhatIfCostModel()
        row = [cm.shuffle_throughput(), cm.io_throughput(),
               cm.shuffle_seconds(1e6, 8), cm.rebalance_seconds(-3.0)]
        cm.observe_shuffle(1e6, 0.01)
        cm.observe_shuffle(0, 1.0)                 # ignored sample
        row += [cm.shuffle_throughput(), cm.repartition_throughput(),
                cm.padding_overhead_s(5e6, 2e6), cm.shuffle_seconds(1e6, 1)]
        got.append(row)
    assert got[0] == got[1]
    assert tsvc.cost_model.DEFAULT_BANDWIDTH == 1.25e9
    assert tsvc.cost_model.DEFAULT_DISK_BANDWIDTH == 2e9


# ---------------------------------------------------------------------------
# the Observer
# ---------------------------------------------------------------------------

def _seed(store, svc, **kw):
    for name, data in svc.drift_tables(**kw).items():
        store.write(name, data)
    return store


@pytest.mark.parametrize("port", sorted(PORT_STORES))
def test_observer_records_and_auto_compaction_match_reference(pinned, port):
    obs = {}
    for pkg, svc, sess in (
            ("ref", jsvc, JSession(_seed(JStore(8), jsvc, n_lineitem=1000))),
            ("port", tsvc, TSession(_seed(PartitionStore(
                8, **PORT_STORES[port]), tsvc, n_lineitem=1000)))):
        o = svc.Observer(clock=svc.LogicalClock(), max_records=3,
                         compact_slack=1).attach(sess)
        for _ in range(6):
            sess.run(svc.q_orderkey())
        obs[pkg] = o
    t, j = obs["port"], obs["ref"]
    assert t.records_seen == j.records_seen == 6
    assert t.compacted_total == j.compacted_total > 0
    assert [dataclasses.asdict(r) for r in t.history.records] == \
        [dataclasses.asdict(r) for r in j.history.records]
    assert len(t.history.records) <= 4
    assert sum(r.weight for r in t.history.records) == 6.0
    assert t.history.records[-1].timestamp == 6.0
    assert t.history.records[-1].candidate_stats[ORDERKEY_SIG]


def test_observer_adopts_the_executor_record(pinned):
    """A session logging into the same history: one record per run, not
    two (the Observer adopts the executor's append)."""
    for svc, core, sess_cls, store in (
            (jsvc, jcore, JSession, JStore(4)),
            (tsvc, tcore, TSession, PartitionStore(4, backend="host"))):
        hist = core.HistoryStore()
        sess = sess_cls(_seed(store, svc, n_lineitem=500), history=hist)
        o = svc.Observer(hist, clock=svc.LogicalClock()).attach(sess)
        sess.run(svc.q_orderkey())
        sess.run(svc.q_orderkey())
        assert len(hist.records) == 2 and o.records_seen == 2


# ---------------------------------------------------------------------------
# skew actions: salt, rebucket, unsalt (tests/test_skew_adaptive.py)
# ---------------------------------------------------------------------------

def _skewed(svc, sess_cls, store, **cfg_kw):
    _seed(store, svc, n_lineitem=4000, skew=1.5)
    sess = sess_cls(store)
    cfg = svc.AutopilotConfig(min_runs=2.0, hysteresis=0.5, cooldown_ticks=0,
                              skew_actions=True, **cfg_kw)
    return sess, svc.Autopilot(sess, clock=svc.LogicalClock(), config=cfg)


def _pair(port, **cfg_kw):
    j = _skewed(jsvc, JSession, JStore(8), **cfg_kw)
    t = _skewed(tsvc, TSession, PartitionStore(8, **PORT_STORES[port]),
                **cfg_kw)
    return j, t


def _inject(ap, shuffle=True, io=True, repartition=False):
    """The reference test's calibrations (fast network, slow storage),
    straight into the calibrations the ``pinned`` fixture leaves alone."""
    if shuffle:
        ap.cost_model.shuffle_cal.observe(1e9, 0.1)
    if io:
        ap.cost_model.io_cal.observe(1e6, 1.0)
    if repartition:
        ap.cost_model.repartition_cal.observe(1e9, 0.1)


def _run_both(pair, n=1):
    out = []
    for (sess, _ap), svc in zip(pair, (jsvc, tsvc)):
        wl = svc.q_orderkey()
        for _ in range(n):
            vals, stats = sess.run(wl)
        out.append((svc.aggregate_result(vals, wl), stats))
    (jres, jst), (tres, tst) = out
    _same_arrays(tres, jres)
    assert (tst.shuffles_performed, tst.shuffles_elided) == \
        (jst.shuffles_performed, jst.shuffles_elided)
    return tres, tst


def _tick_both(pair, port):
    (jsess, jap), (tsess, tap) = pair
    jrep, trep = jap.tick(), tap.tick()
    _same_tick(trep, jrep, with_path=port == "host")
    if port == "device":
        want = {"repartition": "d2d", "unsalt": "d2d", "salt": "host",
                "rebucket": "rebucket"}
        for a in trep.applied:
            assert a.path == want[a.kind], a
    for name in ("lineitem", "orders"):
        _same_layout(tsess.store.read(name), jsess.store.read(name), name)
    return trep


@pytest.mark.parametrize("port", sorted(PORT_STORES))
def test_salt_matches_reference(pinned, port):
    pair = _pair(port)
    _run_both(pair, 3)
    ref, _ = _run_both(pair)
    _inject(pair[0][1])
    _inject(pair[1][1])
    rep1 = _tick_both(pair, port)
    assert ("lineitem", "repartition") in {(a.dataset, a.kind)
                                           for a in rep1.applied}
    rep2 = _tick_both(pair, port)
    salt = next(a for a in rep2.applied if a.kind == "salt")
    assert salt.decision.candidate.hot_keys
    ds = pair[1][0].store.read("lineitem")
    assert "salt" in ds.partitioner.signature()
    if port == "device":
        assert isinstance(ds.columns["qty"], torch.Tensor)
    got, stats = _run_both(pair)
    assert stats.shuffles_performed >= 1
    _same_arrays(got, ref)
    rep3 = _tick_both(pair, port)
    assert "salt" not in {a.kind for a in rep3.applied}


@pytest.mark.parametrize("port", sorted(PORT_STORES))
def test_rebucket_action_matches_reference(pinned, port):
    pair = _pair(port, hot_key_fraction=2.0)
    _run_both(pair, 2)
    ref, _ = _run_both(pair)
    _inject(pair[0][1])
    _inject(pair[1][1])
    _tick_both(pair, port)
    rep2 = _tick_both(pair, port)
    a = next(x for x in rep2.applied
             if x.dataset == "lineitem" and x.kind == "rebucket")
    assert a.decision is None and a.moved_bytes == 0
    assert a.score.padding_benefit_s > 0
    ds = pair[1][0].store.read("lineitem")
    assert ds.capacity_map is not None
    assert ds.partitioner.signature() == ORDERKEY_SIG
    got, stats = _run_both(pair)
    assert stats.shuffles_elided >= 1
    _same_arrays(got, ref)
    rep3 = _tick_both(pair, port)
    assert "rebucket" not in {x.kind for x in rep3.applied}


@pytest.mark.parametrize("port", sorted(PORT_STORES))
def test_unsalt_matches_reference(pinned, port):
    pair = _pair(port, window_s=6.0)
    _run_both(pair, 3)
    _inject(pair[0][1])
    _inject(pair[1][1])
    _tick_both(pair, port)
    _tick_both(pair, port)
    _inject(pair[0][1], shuffle=False, io=False, repartition=True)
    _inject(pair[1][1], shuffle=False, io=False, repartition=True)
    rep_hot = _tick_both(pair, port)
    assert not any(a.kind in ("unsalt", "repartition")
                   for a in rep_hot.applied if a.dataset == "lineitem")
    cooled = {svc: svc.drift_tables(n_lineitem=4000, skew=0.0, seed=1)
              for svc in (jsvc, tsvc)}
    for (sess, _ap), svc in zip(pair, (jsvc, tsvc)):
        sess.store.write("lineitem", cooled[svc]["lineitem"],
                         partitioner=sess.store.read("lineitem").partitioner)
    ref, stats = _run_both(pair)
    assert stats.shuffles_performed >= 1
    _run_both(pair, 6)
    rep = _tick_both(pair, port)
    a = next(x for x in rep.applied if x.kind == "unsalt")
    assert a.dataset == "lineitem"
    assert pair[1][0].store.read("lineitem").partitioner.signature() \
        == ORDERKEY_SIG
    got, stats = _run_both(pair)
    assert stats.shuffles_elided >= 1
    _same_arrays(got, ref)
    rep2 = _tick_both(pair, port)
    assert not any(x.kind in ("salt", "unsalt") for x in rep2.applied)


# ---------------------------------------------------------------------------
# the store methods the service calls
# ---------------------------------------------------------------------------

def _cand(svc, core):
    return core.enumerate_candidates(svc.q_orderkey().graph, "lineitem")[0]


@pytest.mark.parametrize("skew", [1.5, 0.0], ids=["zipf", "uniform"])
@pytest.mark.parametrize("port", sorted(PORT_STORES))
def test_rebucket_matches_reference(port, skew, monkeypatch):
    tables = jsvc.drift_tables(n_lineitem=3000, skew=skew, seed=4)
    jstore = JStore(8)
    tstore = PartitionStore(8, **PORT_STORES[port])
    jds = jstore.write("lineitem", tables["lineitem"], _cand(jsvc, jcore))
    tds = tstore.write("lineitem", tables["lineitem"], _cand(tsvc, tcore))
    assert tds.padding_waste() == jds.padding_waste() > 0

    def no_host_gather(self):
        raise AssertionError("rebucket gathered to the host")
    if port == "device":
        monkeypatch.setattr(StoredDataset, "gather", no_host_gather)
    tnew, tmoved = tstore.rebucket("lineitem")
    jnew, jmoved = jstore.rebucket("lineitem")
    monkeypatch.undo()
    assert tmoved == jmoved == 0
    _same_layout(tnew, jnew)
    assert tnew.padding_waste() == jnew.padding_waste()
    tlog, jlog = dict(tstore.write_log[-1]), dict(jstore.write_log[-1])
    tlog.pop("latency"), jlog.pop("latency")
    assert tlog == jlog
    if skew:
        assert tnew.capacity_map is not None and tnew.generation == 1
        assert tlog["path"] == "rebucket"
        assert tnew.padding_waste() < tds.padding_waste()
    else:                                    # planned map == current: no-op
        assert tnew is tds
    if port == "device":
        assert all(isinstance(v, torch.Tensor) for v in tnew.columns.values())
    _same_arrays(tnew.gather(), jnew.gather())
    # idempotent once the planned map is the current one
    assert tstore.rebucket("lineitem")[0] is tnew


@pytest.mark.parametrize("port", sorted(PORT_STORES))
def test_namespace_bytes_and_stored_partitioners_match_reference(port):
    stores = {"ref": (JStore(4), jcore), "port": (
        PartitionStore(4, **PORT_STORES[port]), tcore)}
    got = {}
    for pkg, (store, core) in stores.items():
        wl = core.Workload("w")
        d = wl.scan("alice::a")
        wl.partition(d["k"])
        cand = core.enumerate_candidates(wl.graph, "alice::a")[0]
        r = np.random.default_rng(9)
        store.write("alice::a", {"k": r.integers(0, 50, 300),
                                 "v": r.random(300).astype(np.float32)}, cand)
        store.write("alice::b", {"x": np.arange(70, dtype=np.int32)})
        store.write("bob::a", {"k": r.integers(0, 9, 41)})
        got[pkg] = ({p: store.namespace_bytes(p)
                     for p in ("", "alice::", "bob::", "carol::")},
                    {n: p.signature() if p is not None else None
                     for n, p in store.stored_partitioners().items()},
                    {n: store.read(n).padding_waste()
                     for n in sorted(store.datasets)})
    assert got["port"] == got["ref"]
    assert got["port"][0]["carol::"] == 0


def test_store_cluster_and_mesh_surfaces():
    store = PartitionStore(4, backend="device", device="cpu")
    assert store.is_cluster is False and store.directory is None
    store.write("d", {"k": np.arange(20)})
    from repro_torch.core.sharding_bridge import Mesh, sharding_of
    mesh = Mesh(["cpu"], ("data",))
    keyed = store.write("o", {"orderkey": np.arange(20)})
    new, _ = store.repartition(keyed, _cand(tsvc, tcore), mesh=mesh)
    assert store.read(new.name) is new
    assert sharding_of(new, "orderkey").mesh == mesh
    two = Mesh(["cpu"] * 2, ("data",))
    placed, _ = store.repartition(keyed, _cand(tsvc, tcore), mesh=two)
    assert sharding_of(placed, "orderkey").mesh == two
    assert [s for _, _, s, _ in placed.columns["orderkey"].shards()] == [
        slice(0, 2), slice(2, 4)]
    np.testing.assert_array_equal(placed.gather()["orderkey"],
                                  new.gather()["orderkey"])
    # cluster actions forced on over a store with no health signals: the
    # phase runs and finds nothing, as in the reference
    forced = tsvc.StorageOptimizer(store, tcore.HistoryStore(),
                                   config=tsvc.AutopilotConfig(
                                       cluster_actions=True))
    assert forced._cluster_enabled() is True
    assert forced.tick().applied == []
    opt = tsvc.StorageOptimizer(store, tcore.HistoryStore())
    assert opt._cluster_enabled() is False
    store.synchronize()                      # a no-op off the card


# ---------------------------------------------------------------------------
# Session.autopilot / explain_decisions across a durable root
# ---------------------------------------------------------------------------

def _events(seed=3, n=800):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 37, size=n),
            "v": np.arange(n, dtype=np.float32) + seed}


def _consumer(core):
    wl = core.Workload("consumer")
    x = wl.scan("events")
    wl.aggregate(x, key=x["k"], reducer="sum")
    return wl


def _durable(pkg, root):
    if pkg == "ref":
        return lachesis.Session(store_path=root, num_workers=4), jcore, jsvc
    return (lachesis_torch.Session(store_path=root, num_workers=4,
                                   device="cpu"), tcore, tsvc)


def _fresh(pkg, root):
    return _durable(pkg, root)[0]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_autopilot_explain_decisions_round_trip(pinned, tmp_path, writer):
    recs = {}
    for pkg in ("ref", "port"):
        root = str(tmp_path / pkg)
        sess, core, svc = _durable(pkg, root)
        sess.write("events", _events())
        ap = sess.autopilot(clock=svc.LogicalClock())
        sess.run(_consumer(core))
        sess.run(_consumer(core))
        rep = ap.tick()
        assert [(a.dataset, a.kind) for a in rep.applied] == \
            [("events", "repartition")]
        recs[pkg] = (sess.explain_decisions(), root)
    live, root = recs[writer]
    assert live == recs["ref" if writer == "port" else "port"][0]
    assert live and all(r["kind"] == "why" for r in live)
    # a fresh session of either package on the writer's root reads the
    # same records back from decisions.log
    for reader in ("ref", "port"):
        assert _fresh(reader, root).explain_decisions() == live
        assert _fresh(reader, root).explain_decisions(limit=1) == live[-1:]
    port = _fresh("port", root)
    assert port.read("events").generation == 1
    assert port.run(_consumer(tcore)).stats.shuffles_elided == 1


@pytest.mark.parametrize("kw", [dict(device="cpu"), dict(backend="host")],
                         ids=["device-cpu", "host"])
def test_session_autopilot_and_serve_on_the_cpu(kw):
    sess = lachesis_torch.Session(num_workers=4, **kw)
    _seed(sess.store, tsvc, n_lineitem=800)
    ap = sess.autopilot(clock=tsvc.LogicalClock(),
                        config=tsvc.AutopilotConfig(hysteresis=0.5))
    assert isinstance(ap, tsvc.Autopilot) and sess._autopilots == [ap]
    assert sess.explain_decisions() == []
    with sess.serve(max_workers=2, max_queue=4) as front:
        assert isinstance(front, tsvc.ServingFrontend)
        for _ in range(2):
            front.run(tsvc.q_orderkey(), timeout=60)
    rep = ap.tick()
    assert {a.dataset for a in rep.applied} >= {"lineitem", "orders"}
    assert sess.explain_decisions() and sess.explain_decisions(limit=2) == \
        ap.explain()[-2:]
    assert sess.read("lineitem").partitioner.signature() == ORDERKEY_SIG
