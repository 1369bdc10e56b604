"""The history → features → advisor loop (paper Alg. 3) and the legacy
``Engine`` facade of the torch port, against the reference.

The same traced workloads go through both packages: the ``HistoryStore``
skeleton graphs, the candidates, ``candidate_features`` (floats to 1e-12
relative) and the ``GreedySelector`` decision must be equal.  A history
JSONL crosses between the packages, compaction gives the same aggregates,
``apply_decision`` gives the reference's layout, and ``Engine`` warns and
matches ``Session``.  Mirrors ``tests/test_matching_history_advisor.py``
and ``tests/test_engine.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lachesis  # noqa: E402
import lachesis_torch  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.dsl import reddit_loader as jloader  # noqa: E402
from repro.core.features import FEATURE_NAMES  # noqa: E402
from repro.data.partition_store import PartitionStore as JStore  # noqa: E402
from repro_torch.core.dsl import reddit_loader as tloader  # noqa: E402
from repro_torch.data.partition_store import PartitionStore  # noqa: E402

PKGS = {"ref": (jcore, jloader), "port": (tcore, tloader)}


# -- traced workloads, built with either package's DSL ------------------------

def _q04(core):
    wl = core.Workload("q04-like")
    li, od = wl.scan("lineitem"), wl.scan("orders")
    j = wl.join(li, od, left_key=li["orderkey"], right_key=od["orderkey"],
                tag="li_orders")
    wl.filter(j, j["qty"] > 40)
    return wl


def _q17(core):
    wl = core.Workload("q17-like")
    li, pt = wl.scan("lineitem"), wl.scan("part")
    j = wl.join(li, pt, left_key=li["partkey"], right_key=pt["partkey"],
                tag="li_part")
    wl.aggregate(j, key=j["size"], reducer="mean")
    return wl


def _tpch_loader(core):
    wl = core.Workload("tpch-loader")
    raw = wl.scan("lineitem_raw")
    wl.write(wl.map(raw, fn=lambda x: x, tag="parse_tbl"), "lineitem")
    return wl


def _reddit_history(core, loader, n=3, stats=True):
    hist = core.HistoryStore()
    ld = loader("loader", "raw", "submissions", "json")
    consumer = core.author_integrator()
    sig = core.enumerate_candidates(consumer.graph, "submissions")[0] \
        .signature()
    for t in range(n):
        hist.log_workload(ld, timestamp=100.0 * t, latency=40.0,
                          input_bytes=2e9)
        hist.log_workload(
            consumer, timestamp=100.0 * t + 50, latency=120.0,
            input_bytes=3e9,
            candidate_stats={sig: {"selectivity": 0.1, "distinct_keys": 1e6,
                                   "num_objects": 2e7}} if stats else None)
    return hist, ld, "submissions"


def _tpch_history(core, loader, n_q04=3, n_q17=5):
    """A loader writing lineitem, then q04 runs, then more q17 runs."""
    hist = core.HistoryStore()
    ld = _tpch_loader(core)
    q04, q17 = _q04(core), _q17(core)
    c04 = core.enumerate_candidates(q04.graph, "lineitem")[0].signature()
    c17 = core.enumerate_candidates(q17.graph, "lineitem")[0].signature()
    hist.log_workload(ld, timestamp=0.0, latency=30.0, input_bytes=1.44e9)
    t = 10.0
    for wl, sig, n, lat in ((q04, c04, n_q04, 9.0), (q17, c17, n_q17, 7.5)):
        for i in range(n):
            hist.log_workload(
                wl, timestamp=t, latency=lat + 0.25 * i, input_bytes=1.7e9,
                candidate_stats={sig: {"selectivity": 0.3 + 0.01 * i,
                                       "distinct_keys": 1.5e7 - i,
                                       "num_objects": 6e7}})
            t += 7.0
    return hist, ld, "lineitem"


def _empty_history(core, loader):
    return core.HistoryStore(), loader("loader", "raw", "submissions",
                                       "json"), "submissions"


SCENARIOS = {"reddit": _reddit_history,
             "reddit_no_stats": lambda c, l: _reddit_history(c, l,
                                                             stats=False),
             "tpch_q17_majority": _tpch_history,
             "tpch_q04_majority": lambda c, l: _tpch_history(c, l, 6, 2),
             "no_history": _empty_history}


def _decide(pkg, scenario, **kw):
    core, loader = PKGS[pkg]
    hist, producer, dataset = SCENARIOS[scenario](core, loader)
    dec = core.partitioning_creation(producer, dataset, hist,
                                     dataset_bytes=1.44e9, now=1000.0, **kw)
    return hist, dec


def _feature_rows(dec):
    return [(f.candidate.signature(), f.candidate.strategy,
             [getattr(f, n) for n in FEATURE_NAMES]) for f in dec.features]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_advisor_matches_reference(scenario):
    jh, jd = _decide("ref", scenario)
    th, td = _decide("port", scenario)
    # skeleton graphs: same groups (by IR signature), runs and edges
    (jg, je), (tg, te) = jh.skeleton_graph(), th.skeleton_graph()
    assert sorted(tg) == sorted(jg) and te == je
    for sig in jg:
        assert tg[sig].group_id == jg[sig].group_id
        assert [r.app_id for r in tg[sig].runs] == \
            [r.app_id for r in jg[sig].runs]
    # candidates, features and the decision
    want, got = _feature_rows(jd), _feature_rows(td)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for (_s, _k, gv), (_s2, _k2, wv) in zip(got, want):
        np.testing.assert_allclose(gv, wv, rtol=1e-12, atol=0)
    assert td.consumers == jd.consumers
    assert td.action_index == jd.action_index
    assert td.candidate.signature() == jd.candidate.signature()
    np.testing.assert_allclose(td.state, jd.state, rtol=1e-6, atol=1e-7)
    assert td.state.dtype == jd.state.dtype == np.float32


def test_advisor_decisions_follow_the_history():
    _, q17 = _decide("port", "tpch_q17_majority")
    _, q04 = _decide("port", "tpch_q04_majority")
    assert q17.candidate.signature() == tcore.enumerate_candidates(
        _q17(tcore).graph, "lineitem")[0].signature()
    assert q04.candidate.signature() == tcore.enumerate_candidates(
        _q04(tcore).graph, "lineitem")[0].signature()
    _, none = _decide("port", "no_history")
    assert not none.candidate.is_keyed       # only rr/random in the space
    _, red = _decide("port", "reddit")
    assert red.candidate.is_keyed and red.elapsed_s < 5.0


class _StubAgent:
    """Stands in for the actor-critic agent (ROADMAP Queue 1 item 5): picks
    the highest-scoring allowed action of a fixed linear policy."""

    class cfg:
        num_actions = 12

    def select(self, state, mask, greedy=True):
        w = np.sin(np.arange(state.size, dtype=np.float64))
        scores = np.array([float(np.dot(np.roll(w, a), state))
                           for a in range(self.cfg.num_actions)])
        scores[~mask] = -np.inf
        return int(np.argmax(scores))


def test_drl_selector_matches_reference():
    _, jd = _decide("ref", "tpch_q17_majority",
                    selector=jcore.DRLSelector(_StubAgent()))
    _, td = _decide("port", "tpch_q17_majority",
                    selector=tcore.DRLSelector(_StubAgent()))
    assert td.action_index == jd.action_index < len(td.features)
    assert td.candidate.signature() == jd.candidate.signature()


def test_skeleton_graph_and_consumer_enumeration():
    hist = tcore.HistoryStore()
    loader = tloader("loader", "raw", "submissions", "json")
    consumer = tcore.author_integrator()
    for t in range(3):
        hist.log_workload(loader, timestamp=10.0 * t, latency=5.0,
                          input_bytes=1e9)
        hist.log_workload(consumer, timestamp=10.0 * t + 5, latency=20.0,
                          input_bytes=2e9)
    groups, edges = hist.skeleton_graph()
    assert len(groups) == 2 and len(edges) == 1
    consumers = hist.enumerate_consumers(loader.graph.graph_signature())
    assert len(consumers) == 1 and len(consumers[0].runs) == 3


@pytest.mark.parametrize("build", ["q04", "q17", "loader", "reddit_loader",
                                   "author_integrator", "pagerank"])
def test_graph_signature_matches_reference(build):
    """History files cross between packages only if the IR signatures
    agree."""
    def make(core, loader):
        return {"q04": lambda: _q04(core), "q17": lambda: _q17(core),
                "loader": lambda: _tpch_loader(core),
                "reddit_loader": lambda: loader("l", "raw", "s", "json"),
                "author_integrator": core.author_integrator,
                "pagerank": core.pagerank_iteration}[build]()
    assert make(*PKGS["port"]).graph.graph_signature() == \
        make(*PKGS["ref"]).graph.graph_signature()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_history_jsonl_crosses_packages(tmp_path, direction):
    src, dst = (("ref", "port") if direction == "ref_to_port"
                else ("port", "ref"))
    path = str(tmp_path / "hist.jsonl")
    score, loader = PKGS[src]
    hist = score.HistoryStore(path)
    mem, _, _ = _tpch_history(score, loader)
    for r in mem.records:
        hist.log(r)
    dcore, dloader = PKGS[dst]
    back = dcore.HistoryStore(path)
    assert [dataclasses.asdict(r) for r in back.records] == \
        [dataclasses.asdict(r) for r in hist.records]
    assert back.total_runs() == hist.total_runs()
    assert back.overall_throughput() == hist.overall_throughput()
    # without the IRs (they are not persisted) a decision still loads the
    # groups; re-logging the consumer IRs restores the full decision
    for wl in (_q04(dcore), _q17(dcore)):
        back.irs[wl.graph.graph_signature()] = wl.graph
    got = dcore.partitioning_creation(_tpch_loader(dcore), "lineitem", back,
                                      dataset_bytes=1.44e9, now=1000.0)
    _, want = _decide(src, "tpch_q17_majority")
    assert got.candidate.signature() == want.candidate.signature()


def test_history_persistence(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    hist = tcore.HistoryStore(path)
    hist.log_workload(tloader("loader", "raw", "submissions", "json"),
                      timestamp=1.0, latency=2.0, input_bytes=1e6)
    hist2 = tcore.HistoryStore(path)
    assert len(hist2.records) == 1 and hist2.records[0].app_id == "loader"


@pytest.mark.parametrize("keep", [0, 3, 6, 100])
def test_compact_matches_reference(tmp_path, keep):
    out = {}
    for pkg in ("ref", "port"):
        core, loader = PKGS[pkg]
        path = str(tmp_path / f"{pkg}.jsonl")
        hist = core.HistoryStore(path)
        mem, _, _ = _tpch_history(core, loader, n_q04=4, n_q17=5)
        for r in mem.records:
            hist.log(r)
        removed = hist.compact(keep)
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        out[pkg] = (removed, [dataclasses.asdict(r) for r in hist.records],
                    lines, hist.total_runs())
    assert out["port"] == out["ref"]
    if keep < 10:
        assert out["port"][0] > 0


# ---------------------------------------------------------------------------
# apply_decision and the Engine facade
# ---------------------------------------------------------------------------

def _reddit_data(n_sub=5000, n_auth=1000, seed=0):
    rng = np.random.default_rng(seed)
    subs = {"author": rng.integers(0, n_auth, n_sub).astype(np.int64),
            "score": rng.normal(size=n_sub).astype(np.float32)}
    auths = {"author": np.arange(n_auth, dtype=np.int64),
             "karma": rng.normal(size=n_auth).astype(np.float32)}
    return subs, auths


def _port_store(backend, m=8):
    return PartitionStore(num_workers=m, backend=backend, device="cpu")


@pytest.mark.parametrize("backend", ["host", "device"])
def test_apply_decision_matches_reference(backend):
    subs, _ = _reddit_data()
    layouts = []
    for pkg, store in (("ref", JStore(num_workers=8, backend=backend)),
                       ("port", _port_store(backend))):
        core, _ = PKGS[pkg]
        store.write("submissions", subs)
        _, dec = _decide(pkg, "reddit")
        new, moved = core.apply_decision(store, dec)
        assert new.generation == 1 and store.generation_of(
            "submissions") == 1
        layouts.append((moved, np.asarray(new.counts), new.gather(),
                        new.partitioner.signature()))
        if pkg == "port" and backend == "device":
            assert store.write_log[-1]["path"] == "d2d"
            assert isinstance(new.columns["author"], torch.Tensor)
    (jm, jc, jg, js), (tm, tc, tg, ts) = layouts
    assert (tm, ts) == (jm, js)
    np.testing.assert_array_equal(tc, jc)
    for k in jg:
        assert tg[k].dtype == jg[k].dtype
        np.testing.assert_array_equal(tg[k], jg[k])
    # with a mesh: the same layout, placed on it
    from repro_torch.core.sharding_bridge import Mesh, sharding_of
    store = _port_store(backend)
    store.write("submissions", subs)
    mesh = Mesh(["cpu"], ("data",))
    placed, _ = tcore.apply_decision(store, dec, mesh=mesh)
    assert sharding_of(placed, "author").mesh == mesh
    for k, v in placed.gather().items():
        np.testing.assert_array_equal(v, jg[k])


def _engine_run(core, store, partitioned):
    wl = core.author_integrator()
    subs, auths = _reddit_data()
    if partitioned:
        store.write("submissions", subs,
                    core.enumerate_candidates(wl.graph, "submissions")[0])
        store.write("authors", auths,
                    core.enumerate_candidates(wl.graph, "authors")[0])
    else:
        store.write("submissions", subs)
        store.write("authors", auths)
    with pytest.warns(DeprecationWarning, match="Engine.run is deprecated"):
        vals, stats = core.Engine(store, backend=store.backend).run(wl)
    join = max(n for n, nd in wl.graph.nodes.items() if nd.kind == "join")
    return vals[join], stats, wl


@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["roundrobin", "partitioned"])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_engine_warns_and_matches_session_and_reference(backend,
                                                        partitioned):
    tout, tst, _ = _engine_run(tcore, _port_store(backend), partitioned)
    jout, jst, _ = _engine_run(jcore, JStore(num_workers=8, backend=backend),
                               partitioned)
    sess = lachesis_torch.Session(num_workers=8, backend=backend,
                                  device="cpu")
    subs, auths = _reddit_data()
    wl = tcore.author_integrator()
    for name, data in (("submissions", subs), ("authors", auths)):
        sess.write(name, data, tcore.enumerate_candidates(wl.graph, name)[0]
                   if partitioned else None)
    sres = sess.run(wl)
    sout = sres.values[max(n for n, nd in wl.graph.nodes.items()
                           if nd.kind == "join")]
    want = (0, 2) if partitioned else (2, 0)
    for st in (tst, jst, sres.stats):
        assert (st.shuffles_performed, st.shuffles_elided) == want
    assert tst.shuffle_bytes == jst.shuffle_bytes == sres.stats.shuffle_bytes
    for other in (jout, sout):
        np.testing.assert_array_equal(tout.counts, other.counts)
        for k in other.columns:
            np.testing.assert_array_equal(tout.columns[k], other.columns[k])


def test_engine_logs_history_and_runs_hooks():
    store = _port_store("device")
    subs, auths = _reddit_data(1000, 100)
    store.write("submissions", subs)
    store.write("authors", auths)
    hist = tcore.HistoryStore()
    eng = tcore.Engine(store, history=hist)
    seen = []
    eng.add_run_hook(lambda wl, st: seen.append(st))
    eng.matching = False
    assert eng.matching is False and eng.store is store
    with pytest.warns(DeprecationWarning):
        _vals, stats = eng.run(tcore.author_integrator(), timestamp=5.0)
    assert stats.history_logged is hist and seen == [stats]
    (rec,) = hist.records
    assert rec.timestamp == 5.0 and rec.app_id == "author-integrator"
    assert rec.candidate_stats == stats.candidate_stats != {}


def test_pagerank_iteration_correct():
    n, fanout = 2000, 5
    rng = np.random.default_rng(1)
    neighbors = rng.integers(0, n, (n, fanout)).astype(np.int64)
    pages = {"url": np.arange(n, dtype=np.int64), "neighbors": neighbors}
    ranks = {"url": np.arange(n, dtype=np.int64),
             "rank": np.full(n, 1.0 / n, np.float64)}
    wl = tcore.pagerank_iteration()

    def emit(cols):
        contrib = np.repeat((cols["rank"] / fanout)[:, None], fanout, 1)
        return {"url": cols["neighbors"], "contrib": contrib}
    for node in wl.graph.nodes.values():
        if node.params.get("tag") == "emit_contribs":
            node.params["fn"] = emit
    store = _port_store("device", m=4)
    store.write("pages", pages, tcore.enumerate_candidates(wl.graph,
                                                           "pages")[0])
    store.write("ranks", ranks, tcore.enumerate_candidates(wl.graph,
                                                           "ranks")[0])
    with pytest.warns(DeprecationWarning):
        vals, stats = tcore.Engine(store).run(wl)
    out = vals[max(n_ for n_, nd in wl.graph.nodes.items()
                   if nd.kind == "aggregate")]
    oracle = np.zeros(n)
    np.add.at(oracle, neighbors.reshape(-1),
              np.repeat(ranks["rank"] / fanout, fanout))
    got = np.zeros(n)
    got[out.columns["key"]] = out.columns["contrib"]
    mask = oracle > 0
    np.testing.assert_allclose(got[mask], oracle[mask], rtol=1e-6)
    assert stats.shuffles_elided >= 2


def _pin_latency(orig):
    def log_workload(self, workload, **kw):
        kw["latency"] = 1.0
        return orig(self, workload, **kw)
    return log_workload


def test_session_history_loop_matches_reference(monkeypatch):
    """Runs observed through ``Session(history=)`` on both packages give
    the same records (apart from latency) and the same decision.

    The greedy rule prices each run by its measured latency; on the CPU a
    consumer run here takes about 3 ms, the rule's own threshold for this
    dataset size, so wall-clock noise alone would flip the decision.  Both
    packages log every run at 1 s, as ``test_torch_service``'s ``pinned``
    fixture does, and the decision then depends on the records only."""
    for hist_cls in (jcore.HistoryStore, tcore.HistoryStore):
        monkeypatch.setattr(hist_cls, "log_workload",
                            _pin_latency(hist_cls.log_workload))
    hists = {}
    for pkg, sess_cls, core in (("ref", lachesis.Session, jcore),
                                ("port", lachesis_torch.Session, tcore)):
        hist = core.HistoryStore()
        kw = {} if pkg == "ref" else {"device": "cpu"}
        sess = sess_cls(num_workers=8, backend="device", history=hist, **kw)
        subs, auths = _reddit_data(3000, 400)
        loader = PKGS[pkg][1]("loader", "raw", "submissions", "json")
        sess.write("raw", subs)
        sess.write("authors", auths)
        for t in range(3):
            sess.run(loader, timestamp=100.0 * t)
            sess.run(core.author_integrator(), timestamp=100.0 * t + 50)
        dec = core.partitioning_creation(loader, "submissions", hist,
                                         dataset_bytes=1e8, now=1000.0)
        hists[pkg] = (hist, dec)
    (jh, jd), (th, td) = hists["ref"], hists["port"]

    def rows(h):
        return [{k: v for k, v in dataclasses.asdict(r).items()
                 if k != "latency"} for r in h.records]
    assert rows(th) == rows(jh)
    assert td.candidate.signature() == jd.candidate.signature()
    assert td.candidate.is_keyed


def _sketch_batches(case, rng):
    return {"ints": [rng.integers(0, 100, 1000)],
            "zipf_batches": [rng.zipf(1.3, 5000), rng.integers(0, 20, 300),
                             rng.zipf(2, 100)],
            "floats": [rng.normal(size=500) * 10, rng.normal(size=300)],
            "bools": [rng.random(100) < 0.3, rng.random(50) < 0.9],
            "uint64_past_int64": [np.array([2 ** 63 + 5, 3, 3], np.uint64),
                                  rng.integers(0, 5, 40)],
            "wide_floats_then_int8": [
                rng.integers(-2 ** 40, 2 ** 40, 300).astype(np.float64),
                rng.integers(0, 4, 10).astype(np.int8)],
            "huge_float": [np.array([1e30, -2.5, 3.7]), np.arange(5)],
            "distinct_keys": [rng.permutation(20_000),
                              rng.integers(0, 20_000, 60_000)]}[case]


@pytest.mark.parametrize("k", [1, 3, 8, 50])
@pytest.mark.parametrize("case", ["ints", "zipf_batches", "floats", "bools",
                                  "uint64_past_int64",
                                  "wide_floats_then_int8", "huge_float",
                                  "distinct_keys"])
def test_heavy_hitter_sketch_matches_reference(case, k):
    """The observation pass's sketch (``max_key_fraction`` of the history's
    candidate stats) is merged and shed with numpy in the port; its
    counters, their order and every answer equal the reference's per-key
    dict updates."""
    from repro.data.skew import HeavyHitterSketch as JSketch
    from repro_torch.data.skew import HeavyHitterSketch
    rng = np.random.default_rng(sum(map(ord, case)) + k)
    j, t = JSketch(k), HeavyHitterSketch(k)
    for batch in _sketch_batches(case, rng):
        j.update(batch)
        t.update(batch)
        assert list(t.counters().items()) == list(j.counters().items())
        assert t.n == j.n and t.max_fraction() == j.max_fraction()
        assert t.heavy_hitters(0.01) == j.heavy_hitters(0.01)
