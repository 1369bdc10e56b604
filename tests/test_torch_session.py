"""The whole slice — write → run → repartition — through
``lachesis.Session`` and ``lachesis_torch.Session(device="cpu")``.

The Reddit, PageRank and TPC-H workloads of the reference's device tests
run on both backends over a round-robin store (every shuffle real) and over
a store partitioned on the join keys (Alg. 4 elides them).  Values at every
set-valued node, ``shuffle_bytes``, the elide/shuffle verdicts and
``explain()`` (apart from the backend op's name) must equal the reference.

Known divergence: keys computed by transcendental float UDFs
(``func:exp`` and the like) may differ by an ulp between XLA and torch, so
such keys are held to allclose and not to bit-equal pids.
"""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lachesis  # noqa: E402
import lachesis_torch  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.engine import TableVal as JTableVal  # noqa: E402
from repro_torch.core.executor import TableVal  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


# -- workloads: one builder per case, traced with either package's DSL -------

def _reddit(core, seed=0):
    rng = np.random.default_rng(seed)
    n_sub, n_auth = 4000, 800
    subs = {"author": rng.integers(0, n_auth, n_sub).astype(np.int64),
            "score": rng.normal(size=n_sub).astype(np.float32),
            "ups": rng.integers(0, 1000, n_sub).astype(np.int32)}
    auths = {"author": np.arange(n_auth, dtype=np.int64),
             "karma": rng.normal(size=n_auth).astype(np.float32)}
    return core.author_integrator(), {"submissions": subs, "authors": auths}


def _pagerank(core, seed=1):
    rng = np.random.default_rng(seed)
    n, fanout = 1500, 4
    pages = {"url": np.arange(n, dtype=np.int64),
             "neighbors": rng.integers(0, n, (n, fanout)).astype(np.int64)}
    ranks = {"url": np.arange(n, dtype=np.int64),
             "rank": np.full(n, 1.0 / n, np.float64)}
    wl = core.pagerank_iteration()

    def emit(cols):
        contrib = np.repeat((cols["rank"] / fanout)[:, None], fanout, 1)
        return {"url": cols["neighbors"], "contrib": contrib}
    for node in wl.graph.nodes.values():
        if node.params.get("tag") == "emit_contribs":
            node.params["fn"] = emit
    return wl, {"pages": pages, "ranks": ranks}


def _tpch(core, seed=2):
    rng = np.random.default_rng(seed)
    n_orders, n_lines = 3000, 12_000
    orders = {"orderkey": np.arange(n_orders, dtype=np.int64),
              "odate": rng.integers(0, 2556, n_orders).astype(np.int32)}
    lineitem = {"orderkey": rng.integers(0, n_orders, n_lines),
                "qty": rng.integers(1, 50, n_lines).astype(np.float32)}
    wl = core.Workload("q04-like")
    li = wl.scan("lineitem")
    od = wl.scan("orders")
    j = wl.join(li, od, left_key=li["orderkey"], right_key=od["orderkey"],
                tag="li_orders")
    f = wl.filter(j, j["qty"] > 10)
    agg = wl.aggregate(f, key=f["odate"], reducer="sum")
    wl.write(agg, "q04_out")
    return wl, {"lineitem": lineitem, "orders": orders}


def _arith(core, seed=3):
    """Join on an integer arithmetic projection of the key (binop)."""
    rng = np.random.default_rng(seed)
    left = {"hi": rng.integers(0, 40, 2500).astype(np.int64),
            "lo": rng.integers(0, 1000, 2500).astype(np.int32),
            "scale": np.full(2500, 1000, np.int64),
            "v": rng.normal(size=2500).astype(np.float32)}
    right = {"hi": np.repeat(np.arange(40, dtype=np.int64), 25),
             "lo": np.tile(np.arange(0, 1000, 40, dtype=np.int32), 40),
             "scale": np.full(1000, 1000, np.int64),
             "w": rng.integers(0, 9, 1000).astype(np.int32)}
    wl = core.Workload("arith-join")
    a = wl.scan("left")
    b = wl.scan("right")
    j = wl.join(a, b, left_key=a["hi"] * a["scale"] + a["lo"],
                right_key=b["hi"] * b["scale"] + b["lo"], tag="arith")
    wl.write(j, "arith_out")
    return wl, {"left": left, "right": right}


CASES = {"reddit": _reddit, "pagerank": _pagerank, "tpch": _tpch,
         "arith": _arith}


def _session(pkg, backend, workers=8):
    if pkg is lachesis:
        return lachesis.Session(num_workers=workers, backend=backend)
    return lachesis_torch.Session(num_workers=workers, backend=backend,
                                  device="cpu")


def _load(sess, core, case, partitioned):
    wl, tables = CASES[case](core)
    for name, data in tables.items():
        cand = None
        if partitioned:
            cands = core.enumerate_candidates(wl.graph, name)
            cand = cands[0] if cands else None
        sess.write(name, data, cand)
    return wl


def _strip_op(text):
    return re.sub(r"op=\S+", "op=<op>", text)


@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["roundrobin", "partitioned"])
@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_session_matches_reference(case, backend, partitioned):
    js = _session(lachesis, backend)
    ts = _session(lachesis_torch, backend)
    jwl = _load(js, jcore, case, partitioned)
    twl = _load(ts, tcore, case, partitioned)

    jres = js.run(jwl)
    tres = ts.run(twl)
    jst, tst = jres.stats, tres.stats
    assert tst.shuffles_elided == jst.shuffles_elided
    assert tst.shuffles_performed == jst.shuffles_performed
    assert tst.shuffle_bytes == jst.shuffle_bytes
    assert tst.device_repartitions == jst.device_repartitions
    if partitioned:
        assert tst.shuffles_elided > 0
    else:
        assert tst.shuffles_performed > 0
    assert _strip_op(ts.explain(twl)) == _strip_op(js.explain(jwl))

    for nid, h in jres.values.items():
        if not isinstance(h, JTableVal):
            continue
        d = tres.values[nid]
        assert isinstance(d, TableVal)
        np.testing.assert_array_equal(d.counts, h.counts)
        assert set(d.columns) == set(h.columns)
        for k in h.columns:
            assert d.columns[k].dtype == h.columns[k].dtype, (nid, k)
            np.testing.assert_array_equal(d.columns[k], h.columns[k],
                                          err_msg=f"node {nid} col {k}")
    # the stored outputs match too
    for name in js.store.datasets:
        if name in ts.store.datasets:
            jg, tg = js.read(name).gather(), ts.read(name).gather()
            for k in jg:
                np.testing.assert_array_equal(tg[k], jg[k])


@pytest.mark.parametrize("backend", ["host", "device"])
def test_repartition_matches_reference(backend):
    """Session.repartition (d2d on the device backend) gives the
    reference's layout, and a rerun elides the shuffle it paid for."""
    js = _session(lachesis, backend)
    ts = _session(lachesis_torch, backend)
    jwl = _load(js, jcore, "reddit", False)
    twl = _load(ts, tcore, "reddit", False)
    jnew, jmoved = js.repartition(
        "submissions", jcore.enumerate_candidates(jwl.graph,
                                                  "submissions")[0])
    tnew, tmoved = ts.repartition(
        "submissions", tcore.enumerate_candidates(twl.graph,
                                                  "submissions")[0])
    assert tmoved == jmoved and tnew.generation == jnew.generation == 1
    np.testing.assert_array_equal(tnew.counts, jnew.counts)
    for k, v in jnew.columns.items():
        np.testing.assert_array_equal(
            np.asarray(tnew.columns[k].cpu() if backend == "device"
                       else tnew.columns[k]), np.asarray(v))
    assert ts.run(twl).stats.shuffles_elided == \
        js.run(jwl).stats.shuffles_elided == 1
    if backend == "device":
        assert ts.store.write_log[-1]["path"] == "d2d"


def test_plan_cache_hit_and_generation_flip():
    ts = _session(lachesis_torch, "device")
    twl = _load(ts, tcore, "reddit", False)
    first = ts.run(twl)
    traces = ts.plan_cache_stats()["traces"]
    again = ts.run(twl)
    assert first.stats.plan_cache_hit is False
    assert again.stats.plan_cache_hit is True
    assert ts.plan_cache_stats()["traces"] == traces
    ts.repartition("authors",
                   tcore.enumerate_candidates(twl.graph, "authors")[0])
    assert ts.run(twl).stats.plan_cache_hit is False
    assert "planner_plan_cache_hits_total" in ts.metrics_text()
    assert ts.metrics()["metrics"]


def test_run_hook_candidate_stats_match_reference():
    """The observation pass (run hooks attached) measures the same
    per-candidate stats as the reference."""
    seen = {}
    for pkg, core in ((lachesis, jcore), (lachesis_torch, tcore)):
        sess = _session(pkg, "device")
        wl = _load(sess, core, "reddit", False)
        sess.add_run_hook(lambda w, st, _k=pkg.__name__:
                          seen.__setitem__(_k, st))
        sess.run(wl)
    want, got = seen["lachesis"], seen["lachesis_torch"]
    assert got.candidate_measure_passes == want.candidate_measure_passes == 2
    assert got.candidate_stats == want.candidate_stats


@pytest.mark.parametrize("backend", ["host", "device"])
def test_salted_partitioner_write_matches_reference(backend):
    """A partitioner that opts out of kernel dispatch (hot-key salting)
    takes host pids and still stores the reference's layout."""
    from repro.core.partitioner import SaltedPartitioner as JSalted
    rng = np.random.default_rng(12)
    data = {"author": np.where(rng.random(3000) < 0.4, 7,
                               rng.integers(0, 500, 3000)).astype(np.int64),
            "score": rng.normal(size=3000).astype(np.float32)}
    layouts = []
    for pkg, core, salted in ((lachesis, jcore, JSalted),
                              (lachesis_torch, tcore,
                               tcore.SaltedPartitioner)):
        wl = core.author_integrator()
        base = core.enumerate_candidates(wl.graph, "submissions")[0]
        cand = salted(graph=base.graph, hot_keys=(7,), salt_factor=4)
        ds = _session(pkg, backend).write("submissions", data, cand)
        layouts.append((ds.counts, ds.gather()))
    np.testing.assert_array_equal(layouts[1][0], layouts[0][0])
    for k in data:
        np.testing.assert_array_equal(layouts[1][1][k], layouts[0][1][k])


BINOPS = ["==", "!=", "<", ">", "<=", ">=", "+", "-", "*", "/", "%", "&&",
          "||", "&", "|"]


@pytest.mark.parametrize("op", BINOPS)
def test_binop_width_rules_match_reference(op):
    """Key-projection ops keep the reference's widths: numpy with numpy at
    their own widths, anything touching a literal at 32 bits."""
    from repro.core.ir import resolve_fn as jresolve
    from repro_torch.core.ir import resolve_fn as tresolve, to_numpy
    rng = np.random.default_rng(1)
    a64 = rng.integers(-2 ** 40, 2 ** 40, 64)
    b64 = rng.integers(1, 2 ** 35, 64)
    f64 = rng.normal(size=64)
    i32 = rng.integers(-100, 100, 64).astype(np.int32)
    f32 = rng.normal(size=64).astype(np.float32)
    pairs = [(a64, b64), (a64, 7), (i32, 3), (i32, a64)]
    if op not in ("&", "|"):
        pairs += [(f64, 2.5), (f32, f64), (f32, 2)]
    for x, y in pairs:
        lit = not isinstance(y, np.ndarray)
        jy = jresolve(f"literal:{y!r}", {"value": y})() if lit else y
        ty = tresolve(f"literal:{y!r}", {"value": y})() if lit else y
        want = np.asarray(jresolve(f"binop:{op}", {})(x, jy))
        got = to_numpy(tresolve(f"binop:{op}", {})(x, ty))
        assert got.dtype == want.dtype, (op, x.dtype, y)
        np.testing.assert_array_equal(got, want, err_msg=f"{op} {y!r}")


def test_transcendental_key_is_close_not_bit_equal():
    """func:exp keys: XLA and torch may round the last ulp differently, so
    the key column is held to allclose (pids may differ where it does)."""
    rng = np.random.default_rng(6)
    data = {"x": rng.normal(size=2000).astype(np.float32)}
    keys = []
    for core in (jcore, tcore):
        wl = core.Workload("exp-key")
        s = wl.scan("t")
        wl.partition(s["x"].func("exp"))
        cand = core.enumerate_candidates(wl.graph, "t")[0]
        k = cand.key_fn()(data)
        keys.append(k.numpy() if isinstance(k, torch.Tensor)
                    else np.asarray(k))
    assert keys[0].dtype == keys[1].dtype == np.float32
    np.testing.assert_allclose(keys[1], keys[0], rtol=2e-7, atol=0)


@pytest.mark.parametrize("strategy", ["hash", "range", "roundrobin"])
def test_partition_ids_match_reference(strategy):
    rng = np.random.default_rng(7)
    data = {"k": rng.integers(-5000, 5000, 999).astype(np.int64),
            "f": rng.normal(size=999) * 100}
    for key in ("k", "f"):
        ids = []
        for core in (jcore, tcore):
            wl = core.Workload("pids")
            s = wl.scan("t")
            wl.partition(s[key], strategy=strategy)
            cand = core.enumerate_candidates(wl.graph, "t")[0]
            if strategy == "roundrobin":
                cand = core.PartitionerCandidate(graph=None,
                                                 strategy="roundrobin")
            p = cand.partition_ids(data, 13)
            ids.append(p.numpy() if isinstance(p, torch.Tensor)
                       else np.asarray(p))
        np.testing.assert_array_equal(ids[1], ids[0], err_msg=key)


def test_random_partition_ids_invariants():
    """RANDOM uses torch's generator, whose bits differ from jax.random:
    only its invariants are held (every row one pid in range, seeded)."""
    cand = tcore.PartitionerCandidate(graph=None, strategy="random")
    data = {"v": np.zeros(5000)}
    p = cand.partition_ids(data, 7)
    assert p.shape == (5000,) and p.dtype == torch.int32
    assert int(p.min()) >= 0 and int(p.max()) < 7
    assert torch.equal(p, cand.partition_ids(data, 7))
    # the store's RANDOM dispatch draws from numpy and matches bit for bit
    js = _session(lachesis, "host")
    ts = _session(lachesis_torch, "device")
    jcand = jcore.PartitionerCandidate(graph=None, strategy="random")
    rows = {"v": np.arange(3000, dtype=np.float32)}
    jd = js.write("r", rows, jcand, seed=5)
    td = ts.write("r", rows, cand, seed=5)
    np.testing.assert_array_equal(td.counts, jd.counts)
    np.testing.assert_array_equal(td.gather()["v"], jd.gather()["v"])


def test_device_default_and_cpu_request():
    if torch.cuda.is_available():
        sess = lachesis_torch.Session()
        assert sess.device.type == "cuda" and sess.backend == "device"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            lachesis_torch.Session()
    assert lachesis_torch.Session(device="cpu").device.type == "cpu"
    host = lachesis_torch.Session(backend="host")
    assert host.backend == "host" and host.device.type == "cpu"


PASSTHROUGHS = {
    "flush": lambda s: s.flush(),
    "flush_name": lambda s: s.flush("submissions"),
    "store_path": lambda s: s.store_path,
    "directory": lambda s: s.directory,
    "telemetry_store": lambda s: s.telemetry_store,
    "watchdog": lambda s: s.watchdog,
    "export_node_metrics": lambda s: s.export_node_metrics(),
    "cluster_metrics": lambda s: s.cluster_metrics(),
    "cluster_metrics_text": lambda s: s.cluster_metrics_text(),
    "telemetry": lambda s: s.telemetry(),
    "telemetry_limit": lambda s: s.telemetry(limit=3),
    "explain_decisions": lambda s: s.explain_decisions(),
}


@pytest.mark.parametrize("name", sorted(PASSTHROUGHS))
def test_in_memory_passthroughs_match_reference(name):
    """On a memory-only store the reference answers every storage,
    cluster and telemetry passthrough; the port answers the same."""
    ask = PASSTHROUGHS[name]
    want = ask(lachesis.Session(num_workers=4))
    got = ask(lachesis_torch.Session(num_workers=4, device="cpu"))
    assert type(got) is type(want) and got == want


@pytest.mark.parametrize("call", ["export_trace", "plan_rebalance",
                                  "rebalance"])
def test_unported_surfaces_name_their_roadmap_item(call):
    """The surfaces that once raised, naming ROADMAP Queue 1 item 4, answer
    as the reference's on a memory-only session: ``export_trace`` returns
    a Chrome trace document, the rebalance calls refuse a store that is
    not a cluster store with the reference's error."""
    ref, port = lachesis.Session(num_workers=4), \
        lachesis_torch.Session(num_workers=4, device="cpu")
    if call == "export_trace":
        want, got = ref.export_trace(), port.export_trace()
        assert set(got) == set(want)
        assert got["otherData"]["num_workers"] == 4
        assert got["otherData"]["session_backend"] == "device"
        return
    with pytest.raises(ValueError) as want:
        getattr(ref, call)()
    with pytest.raises(ValueError) as got:
        getattr(port, call)()
    assert str(got.value) == str(want.value)


def _durable_reddit(sess, core):
    wl, tables = _reddit(core)
    for name, data in tables.items():
        sess.write(name, data, core.enumerate_candidates(wl.graph, name)[0])
    sess.run(wl)
    sess.run(wl)


DURABLE_TIMINGS = ("t", "process", "wall_s", "shuffle_s", "io_s",
                   "planning_s")


def _durable_answer(name, value, root):
    """An answer with its timings and its store root taken out."""
    if name in ("telemetry", "telemetry_limit"):
        return [{k: v for k, v in p.to_record().items()
                 if k not in DURABLE_TIMINGS} for p in value]
    if name in ("store_path", "export_node_metrics"):
        return None if value is None else \
            str(Path(value).relative_to(root))
    if name == "cluster_metrics":
        return {k: v for k, v in value.items()
                if k not in ("metrics", "generated_unix_s")}, \
            sorted(value["metrics"])
    if name == "cluster_metrics_text":
        return len(value) > 0
    if name == "telemetry_store":
        return {k: v for k, v in value.stats().items() if k != "path"}
    if name == "watchdog":
        return (value.window, value.tolerance, value.min_runs, value.checks,
                value.raised_total, value.registry is not None)
    return value


@pytest.mark.parametrize("name", sorted(PASSTHROUGHS))
def test_durable_passthroughs_match_reference(tmp_path, name):
    """Over a ``store_path`` both packages answer every storage, cluster
    and telemetry passthrough with values of the same type, equal apart
    from timings (and the store's own path)."""
    from repro.obs.metrics import MetricsRegistry as JRegistry
    from repro_torch.obs.metrics import MetricsRegistry
    answers = []
    for pkg, core, reg in ((lachesis, jcore, JRegistry),
                           (lachesis_torch, tcore, MetricsRegistry)):
        root = tmp_path / pkg.__name__
        kw = {} if pkg is lachesis else {"device": "cpu"}
        sess = pkg.Session(num_workers=4, backend="host", autoflush=False,
                           store_path=str(root), metrics=reg(), **kw)
        _durable_reddit(sess, core)
        got = PASSTHROUGHS[name](sess)
        answers.append((type(got).__name__,
                        _durable_answer(name, got, root)))
    (jt, want), (tt, got) = answers
    assert tt == jt
    assert got == want
    if name == "flush":
        assert got == 3          # submissions, authors, integrated


@pytest.mark.parametrize("tier", ["cluster", "cluster_root"])
def test_unported_tiers_raise(tmp_path, tier):
    """The cluster tier is ported: ``cluster=`` without ``store_path=``,
    and a root whose ``cluster.json`` names no nodes, raise as in the
    reference; a root holding a real cluster store opens as one."""
    if tier == "cluster":
        kws = [{"cluster": pkg.ClusterConfig(nodes=("a", "b"))}
               for pkg in (lachesis, lachesis_torch)]
        err = ValueError
    else:
        (tmp_path / "cluster.json").write_text("{}")
        kws = [{"store_path": str(tmp_path)}] * 2
        err = KeyError
    with pytest.raises(err) as want:
        lachesis.Session(**kws[0])
    with pytest.raises(err) as got:
        lachesis_torch.Session(device="cpu", **kws[1])
    assert str(got.value) == str(want.value)
    root = tmp_path / "real"
    lachesis.Session(store_path=str(root), num_workers=4,
                     cluster=lachesis.ClusterConfig(nodes=("a", "b")))
    sess = lachesis_torch.Session(store_path=str(root), device="cpu")
    assert sess.store.is_cluster and sess.directory.nodes == ("a", "b")
    assert sess.num_workers == 4


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import lachesis_torch
        from repro_torch.core import author_integrator, enumerate_candidates
        sess = lachesis_torch.Session(num_workers=4, device="cpu")
        wl = author_integrator()
        sess.write("submissions", {"author": np.arange(50) % 7,
                                   "score": np.ones(50, np.float32)})
        sess.write("authors", {"author": np.arange(7)})
        res = sess.run(wl)
        assert res.stats.shuffles_performed == 2
        sess.repartition("submissions",
                         enumerate_candidates(wl.graph, "authors")[0])
        # the durable tier, telemetry, watchdog, history → advisor, engine
        import tempfile
        import warnings
        from repro_torch.core import (Engine, HistoryStore, apply_decision,
                                      partitioning_creation)
        from repro_torch.core.dsl import reddit_loader
        from repro_torch.data.storage import DurableStore, load_current
        from repro_torch.obs import RegressionDetector, TelemetryStore
        root = tempfile.mkdtemp()
        hist = HistoryStore(root + "/history.jsonl")
        dur = lachesis_torch.Session(num_workers=4, device="cpu",
                                     store_path=root + "/s", history=hist,
                                     memory_budget_bytes=1 << 20)
        loader = reddit_loader("loader", "raw", "submissions", "json")
        dur.write("raw", {"author": np.arange(50) % 7,
                          "score": np.ones(50, np.float32)})
        dur.write("authors", {"author": np.arange(7)})
        dur.run(loader, timestamp=1.0)
        dur.run(wl, timestamp=2.0)
        dec = partitioning_creation(loader, "submissions", hist,
                                    dataset_bytes=1e6)
        apply_decision(dur.store, dec)
        assert dur.store.spill("submissions") and dur.flush() == 0
        again = lachesis_torch.Session(store_path=root + "/s", device="cpu")
        assert again.read("submissions").generation == 1
        assert len(again.telemetry()) == 2
        assert isinstance(again.watchdog, RegressionDetector)
        assert isinstance(again.telemetry_store, TelemetryStore)
        assert again.export_node_metrics("n") and again.cluster_metrics()
        assert DurableStore(root + "/s").decisions() == []
        assert load_current(root + "/s/datasets/submissions").generation == 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            Engine(again.store).run(wl)
        # the service: drift scenario, Autopilot, serving frontend
        from repro_torch.service import (AutopilotConfig, LogicalClock,
                                         q_orderkey, run_drift_scenario)
        rep = run_drift_scenario(device="cpu", n_lineitem=2000)
        assert rep.lineitem_generations == [0, 1, 2]
        svc = lachesis_torch.Session(num_workers=4, device="cpu",
                                     store_path=root + "/svc")
        for name in ("lineitem", "orders", "part"):
            svc.write(name, rep.store.read(name).gather())
        ap = svc.autopilot(clock=LogicalClock(),
                           config=AutopilotConfig(hysteresis=0.0))
        with svc.serve(max_workers=2, max_queue=4) as front:
            for _ in range(2):
                front.run(q_orderkey(), timeout=60)
        assert [a.path for a in ap.tick().applied] == ["d2d", "d2d"]
        assert lachesis_torch.Session(
            store_path=root + "/svc", device="cpu").explain_decisions() \
            == svc.explain_decisions()
        # the cluster tier, the runtime modules and the trace exporter
        from repro_torch.cluster import ClusterConfig, Rebalancer
        from repro_torch.obs import (enable, disable, spill_spans,
                                     write_merged_trace)
        from repro_torch.obs.export import to_chrome_trace
        from repro_torch.runtime import elastic, fault_tolerance, straggler
        enable("full", process="isolated")
        cl = lachesis_torch.Session(
            num_workers=4, device="cpu", store_path=root + "/cl",
            cluster=ClusterConfig(nodes=("a", "b")))
        cl.write("d", {"k": np.arange(40)})
        assert cl.rebalance(add_nodes=("c",)).epoch == 1
        assert Rebalancer(cl.store).plan(remove_nodes=("a",)).moved
        assert to_chrome_trace()["otherData"]["spans"] > 0
        spill_spans(root + "/spans", "isolated")
        assert write_merged_trace(root + "/t.json", root + "/spans")
        disable()
        # the LM serving slice: configs, kernels, models, serve
        import torch
        from repro_torch.configs import get_config
        from repro_torch.configs.reduced import reduced
        from repro_torch.kernels.flash_attention import flash_attention, ops
        from repro_torch.kernels.ssd_scan import ssd_scan, ops as ssd_ops
        from repro_torch.launch import serve
        from repro_torch.models import convert, layers, ssd, transformer
        for arch in ("internlm2-1.8b", "mamba2-370m"):
            cfg = reduced(get_config(arch))
            params = transformer.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu")
            gen, _ = serve.serve_batch(cfg, params, np.zeros((1, 8), np.int32),
                                       2, device="cpu")
            assert gen.shape == (1, 2)
        # the training slice: DRL selector, optimizer, checkpoints, the
        # token pipeline, train steps and the driver
        from repro_torch.core.drl import (A3CAgent, A3CConfig, Transition,
                                          TraceSimulator, tpch_like_library)
        from repro_torch.core import DRLSelector
        from repro_torch.optimizer import adamw, compression, schedule
        from repro_torch.checkpoint import checkpoint
        from repro_torch.data import pipeline
        from repro_torch.launch import steps, train
        from repro_torch import tree
        queries, scfg = tpch_like_library()
        sim = TraceSimulator(queries, scfg)
        agent = A3CAgent(A3CConfig(state_dim=sim.state_dim,
                                   num_actions=scfg.num_candidates),
                         device="cpu")
        wl_ = sim.sample_workload()
        st_, mk_ = sim.state_of(wl_)
        agent.train_batch([Transition(st_, agent.select(st_, mk_),
                                      sim.reward_of(wl_, 0), mk_)] * 4)
        out = train.train_with_restarts(train.TrainRun(
            cfg=reduced(get_config("mamba2-370m")), total_steps=3,
            global_batch=2, seq_len=16, ckpt_dir=root + "/ck",
            ckpt_every=2, fail_at_step=2, device="cpu"))
        assert out["start_step"] == 2 and len(tree.leaves(out["state"]))
        assert checkpoint.latest_step(root + "/ck") == 3
        assert pipeline.TokenSource(pipeline.DataConfig(
            vocab_size=10, seq_len=4, global_batch=2)).batch_at(0, 0)
        rcfg = reduced(get_config("internlm2-1.8b"))
        opt = adamw.AdamW(lr=schedule.warmup_cosine(1e-3, 2, 10))
        st = steps.init_train_state(rcfg, torch.Generator().manual_seed(0),
                                    opt, compression="int8", device="cpu")
        tok = torch.zeros((2, 16), dtype=torch.int32)
        st, met = steps.make_train_step(rcfg, opt, compression="int8")(
            st, {"tokens": tok, "labels": tok})
        assert met["wire_bytes"] > 0 and isinstance(
            st["ef"], compression.ErrorFeedbackState)
        # mesh placement, the sharding advisor, MoE and MLA
        from repro_torch.core import sharding_advisor
        from repro_torch.core.sharding_bridge import Mesh, sharding_of
        from repro_torch.models import mla, moe
        ms = lachesis_torch.Session(num_workers=4, device="cpu")
        wl = author_integrator()
        ms.write("submissions", {"author": np.arange(30),
                                 "score": np.ones(30, np.float32)})
        placed, _ = ms.repartition(
            "submissions", enumerate_candidates(wl.graph, "submissions")[0],
            mesh=Mesh(["cpu"], ("data",)))
        assert sharding_of(placed, "score") is not None
        assert sharding_advisor.dominant_term(
            {"compute_s": 1, "memory_s": 2, "collective_s": 0}) == 2
        for arch in ("deepseek-v2-236b", "llama4-maverick-400b-a17b",
                     "chameleon-34b"):
            cfg = reduced(get_config(arch))
            params = transformer.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu")
            gen, _ = serve.serve_batch(cfg, params, np.zeros((1, 8), np.int32),
                                       2, device="cpu")
            assert gen.shape == (1, 2)
        # the SPMD layer: rules on an abstract mesh, the dry run's modules
        from repro_torch import pjit_utils
        from repro_torch.launch import dryrun, op_analysis, shardings, specs
        from repro_torch.launch.mesh import AbstractMesh
        cfg = get_config("internlm2-1.8b")
        ps = shardings.param_pspecs(cfg, specs.params_struct(cfg),
                                    AbstractMesh((16, 16), ("data", "model")))
        assert tuple(ps["layers"][0]["attn"]["wq"]["w"]) == (None, "model")
        assert not pjit_utils.spmd_enabled() and dryrun and op_analysis
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro",
                                            "lachesis"))
        assert not bad, bad
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
