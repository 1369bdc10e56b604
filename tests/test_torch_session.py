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


@pytest.mark.parametrize("call", ["autopilot", "serve", "export_trace",
                                  "telemetry", "plan_rebalance",
                                  "rebalance"])
def test_unported_surfaces_name_their_roadmap_item(call):
    sess = lachesis_torch.Session(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(sess, call)()


@pytest.mark.parametrize("kw", [{"store_path": "x"},
                                {"memory_budget_bytes": 1},
                                {"cluster": object()}])
def test_unported_tiers_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lachesis_torch.Session(device="cpu", **kw)


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
