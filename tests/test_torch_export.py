"""The port's Chrome-trace exporter (``repro_torch.obs.export``) against
the reference.

* Hand-built spans give the reference's golden event list exactly
  (``tests/test_observability.py``), and the same document as the
  reference's exporter on the same spans.
* ``Session.export_trace`` over a durable store covers every layer the
  run touched, under one ``session.run`` tree.
* A three-label cluster sequence — write, a rebalance that crashes before
  its epoch commit (spilled from ``on_abort`` with its span open), reopen
  — merges into one trace with paired cross-process flows and the open
  ``cluster.rebalance`` flagged ``incomplete``, in both packages alike.
  The three labels run in this process one after another, each under its
  own tracer label and chained through the store's wire carrier, as the
  separate processes of the card smoke (``chip_smoke.py`` phase 11) are.
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.cluster as jcluster  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.service as jsvc  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.cluster as tcluster  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.service as tsvc  # noqa: E402
from repro.obs.tracer import Span as JSpan  # noqa: E402
from repro.obs.tracer import TraceContext as JContext  # noqa: E402
from repro_torch.data.partition_store import PartitionStore  # noqa: E402
from repro_torch.obs.export import to_chrome_trace  # noqa: E402
from repro_torch.obs.tracer import Span, TraceContext  # noqa: E402


@pytest.fixture
def tracing():
    """Full tracing in both packages for one case; the tracers' mode,
    process labels and buffers are restored afterwards."""
    labels = (jobs.TRACER.process, tobs.TRACER.process)
    for o in (jobs, tobs):
        o.clear_spans()
        o.enable("full")
    try:
        yield
    finally:
        for o, label in zip((jobs, tobs), labels):
            o.disable()
            o.clear_spans()
            o.configure(process=label)


def _golden_spans(SpanCls, ContextCls):
    root = SpanCls(name="root", cat="t", span_id=7, parent_id=None,
                   trace_id=3, tid=10, thread_name="MainThread", t0=100.0,
                   t1=100.005, args={"k": "v"})
    ctx = ContextCls(trace_id=3, span_id=7, tid=10,
                     thread_name="MainThread", captured_at=100.001)
    child = SpanCls(name="child", cat="t", span_id=8, parent_id=7,
                    trace_id=3, tid=20, thread_name="pool-0", t0=100.002,
                    t1=100.004, args={}, flow_from=ctx)
    open_span = SpanCls(name="open", cat="t", span_id=9, parent_id=None,
                        trace_id=4, tid=10, thread_name="MainThread",
                        t0=100.001, t1=None)
    return [child, root, open_span]


GOLDEN = [
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 10,
     "args": {"name": "MainThread"}},
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 20,
     "args": {"name": "pool-0"}},
    {"ph": "X", "name": "root", "cat": "t", "pid": 1, "tid": 10,
     "ts": 0.0, "dur": 5000.0,
     "args": {"k": "v", "span_id": 7, "trace_id": 3}},
    {"ph": "X", "name": "open", "cat": "t", "pid": 1, "tid": 10,
     "ts": 1000.0, "dur": 4000.0,
     "args": {"span_id": 9, "trace_id": 4, "incomplete": True}},
    {"ph": "X", "name": "child", "cat": "t", "pid": 1, "tid": 20,
     "ts": 2000.0, "dur": 2000.0,
     "args": {"span_id": 8, "parent_id": 7, "trace_id": 3}},
    {"ph": "s", "id": 1, "name": "handoff", "cat": "flow", "pid": 1,
     "tid": 10, "ts": 1000.0},
    {"ph": "f", "id": 1, "name": "handoff", "cat": "flow", "pid": 1,
     "tid": 20, "ts": 2000.0, "bp": "e"},
]


def test_chrome_trace_golden_shape():
    """Hand-built spans → the reference's exact event list: thread
    metadata first, X events rebased to t=0 in µs, span/parent/trace ids,
    the handoff's s/f pair, and the open span as ``incomplete``."""
    doc = to_chrome_trace(_golden_spans(Span, TraceContext),
                          metadata={"who": "test"})
    assert doc["traceEvents"] == GOLDEN
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["spans"] == 3
    assert doc["otherData"]["incomplete"] == 1
    assert doc["otherData"]["who"] == "test"
    doc2 = to_chrome_trace(_golden_spans(Span, TraceContext),
                           include_open=False)
    assert doc2["otherData"]["spans"] == 2
    json.dumps(doc)
    ref = jobs.to_chrome_trace(_golden_spans(JSpan, JContext),
                               metadata={"who": "test"})
    assert doc["traceEvents"] == ref["traceEvents"]
    want = dict(ref["otherData"], exporter="repro_torch.obs")
    assert doc["otherData"] == want


def test_chrome_trace_json_and_write(tmp_path):
    spans = _golden_spans(Span, TraceContext)
    text = tobs.chrome_trace_json(spans)
    assert json.loads(text)["traceEvents"] == GOLDEN
    doc = tobs.write_chrome_trace(str(tmp_path / "t.json"), spans)
    assert json.loads((tmp_path / "t.json").read_text()) == doc


def _seed(pkg, svc, root, **kw):
    sess = pkg.Session(num_workers=4, store_path=str(root), **kw)
    for name, data in svc.drift_tables(n_lineitem=600, n_orders=200,
                                       n_parts=80).items():
        sess.write(name, data)
    return sess


LAYERS = {"session.run", "planner.lookup", "planner.compile", "exec.run",
          "exec.scan", "exec.partition", "store.write", "store.install",
          "durable.persist"}


@pytest.mark.parametrize("backend", ["host", "device"])
def test_session_trace_covers_all_layers(tmp_path, tracing, backend):
    """``Session.export_trace`` over a durable store: every layer the run
    touched, under one session.run tree, as in the reference."""
    trees = {}
    for pkg, svc, o, kw in (
            (japi, jsvc, jobs, {"backend": "host"}),
            (tapi, tsvc, tobs, {"backend": backend, "device": "cpu"})):
        sess = _seed(pkg, svc, tmp_path / pkg.__name__, **kw)
        sess.run(svc.q_orderkey())
        names = {s.name for s in o.finished_spans()}
        assert LAYERS <= names
        path = tmp_path / f"{pkg.__name__}.json"
        doc = sess.export_trace(str(path))
        loaded = json.loads(path.read_text())
        assert loaded["otherData"]["session_backend"] == \
            doc["otherData"]["session_backend"] == kw["backend"]
        by_id = {e["args"]["span_id"]: e for e in doc["traceEvents"]
                 if e["ph"] == "X"}
        (run,) = [e for e in by_id.values() if e["name"] == "session.run"]
        tree = [e for e in by_id.values()
                if e["args"]["trace_id"] == run["args"]["trace_id"]]
        assert len(tree) >= 5
        assert all(e is run or "parent_id" in e["args"] for e in tree)
        trees[pkg.__name__] = {e["name"] for e in tree} & LAYERS
    assert trees["repro_torch.api"] == trees["repro.api"]
    assert tapi.Session(device="cpu").export_trace()["traceEvents"] \
        is not None


# ---------------------------------------------------------------------------
# three-label merged cluster trace
# ---------------------------------------------------------------------------

PHASES = ("write", "crash", "reopen")


def check_cluster_trace(doc) -> None:
    """The reference's cluster-smoke check over a merged trace: spans
    from all three labels, paired flows with at least one cross-process
    arrow per boundary (each across two pids), and the crashed rebalance
    present as an ``incomplete`` complete-event."""
    other = doc["otherData"]
    procs = other["processes"]
    assert set(procs) == set(PHASES)
    events = doc["traceEvents"]
    by_pid = {}
    for ev in events:
        if ev["ph"] == "X":
            by_pid.setdefault(ev["pid"], []).append(ev)
    for proc, pid in procs.items():
        assert by_pid.get(pid), proc
    starts = [ev for ev in events if ev["ph"] == "s"]
    finishes = [ev for ev in events if ev["ph"] == "f"]
    assert len(starts) == len(finishes)
    assert {ev["id"] for ev in starts} == {ev["id"] for ev in finishes}
    assert other["cross_process_flows"] >= 2
    fin_by_id = {ev["id"]: ev for ev in finishes}
    for ev in starts:
        if ev["name"] == "xproc":
            assert fin_by_id[ev["id"]]["pid"] != ev["pid"]
    reb = [ev for ev in events
           if ev["ph"] == "X" and ev["name"] == "cluster.rebalance"
           and ev["args"].get("incomplete")
           and ev["args"].get("process") == "crash"]
    assert reb
    assert other["incomplete"] >= 1


def _consumer(core):
    wl = core.Workload("cluster-smoke-q")
    t = wl.scan("events")
    p = wl.partition(t["k"])
    wl.aggregate(p, reducer="sum")
    return wl


def _three_labels(root, o, Session, cluster, core, kw):
    """write → crash (abort_after=1, spilled from on_abort) → reopen,
    each under its own tracer label, chained through the wire carrier."""
    rng = np.random.default_rng(14)
    o.configure(process="write")
    sess = Session(store_path=str(root), num_workers=8,
                   cluster=cluster.ClusterConfig(nodes=("node-a", "node-b"),
                                                 replication=2), **kw)
    tele = sess.telemetry_store
    with o.span("cluster_smoke.write", "smoke"):
        tele.save_trace_context(o.TRACER.context(), "write")
        for name in ("events", "metrics"):
            sess.store.write(name, {
                "k": rng.integers(0, 997, 4000).astype(np.int64),
                "v": rng.standard_normal(4000).astype(np.float32)})
        want = {n: sess.store.read(n).gather() for n in ("events", "metrics")}
        sess.run(_consumer(core))
    o.spill_spans(tele.dir, "write")
    o.clear_spans()
    del sess

    o.configure(process="crash")
    sess = Session(store_path=str(root), num_workers=8, **kw)
    tele = sess.telemetry_store
    with o.TRACER.attach(tele.load_trace_context("write")):
        with o.span("cluster_smoke.crash", "smoke"):
            tele.save_trace_context(o.TRACER.context(), "crash")
            with pytest.raises(cluster.RebalanceAborted):
                sess.rebalance(add_nodes=("node-c",), abort_after=1,
                               on_abort=lambda: o.spill_spans(tele.dir,
                                                              "crash"))
    o.clear_spans()
    del sess
    shutil.rmtree(root / "nodes" / "node-c", ignore_errors=True)

    o.configure(process="reopen")
    sess = Session(store_path=str(root), num_workers=8, **kw)
    tele = sess.telemetry_store
    with o.TRACER.attach(tele.load_trace_context("crash")):
        with o.span("cluster_smoke.reopen", "smoke"):
            assert sess.store.placement_epoch == 0
            for n, cols in want.items():
                got = sess.store.read(n).gather()
                for k in cols:
                    np.testing.assert_array_equal(got[k], cols[k])
            res = sess.rebalance(add_nodes=("node-c",))
            assert res.epoch == 1
            sess.run(_consumer(core))
    o.spill_spans(tele.dir, "reopen")
    o.clear_spans()
    doc = o.write_merged_trace(str(root / "cluster_trace.json"), tele.dir,
                               metadata={"smoke": "cluster"})
    check_cluster_trace(doc)
    assert len(sess.telemetry()) >= 2
    return doc


def test_merged_three_label_trace_matches_reference(tmp_path, tracing):
    docs = {}
    for name, o, Session, cluster, core, kw in (
            ("ref", jobs, japi.Session, jcluster, jcore, {}),
            ("port", tobs, tapi.Session, tcluster, tcore,
             {"device": "cpu"})):
        docs[name] = _three_labels(tmp_path / name, o, Session, cluster,
                                   core, kw)
    ref, port = (docs[k]["otherData"] for k in ("ref", "port"))
    for key in ("processes", "cross_process_flows", "incomplete",
                "skipped_files", "dropped", "smoke"):
        assert port[key] == ref[key], key
    assert port["exporter"] == "repro_torch.obs.merge"

    def roots(doc):
        return sorted((ev["args"]["process"], ev["name"])
                      for ev in doc["traceEvents"] if ev["ph"] == "X"
                      and ev["name"].startswith(("cluster_smoke",
                                                 "cluster.rebalance")))
    assert roots(docs["port"]) == roots(docs["ref"])


def test_recorded_store_spans_close_after_their_work(tmp_path, tracing):
    """With tracing on, the store spans that wrap device work record on
    the device backend as on the host one (on the card they close after a
    synchronize); with tracing off nothing is recorded."""
    store = PartitionStore(4, backend="device", device="cpu")
    ds = store.write("d", {"k": np.arange(40), "v": np.ones(40)})
    wl = tcore.Workload("w")
    wl.partition(wl.scan("d")["k"])
    cand = tcore.enumerate_candidates(wl.graph, "d")[0]
    store.repartition(ds, cand, swap=True)
    names = [s.name for s in tobs.finished_spans()]
    for want in ("store.write", "store.repartition", "shuffle.dispatch"):
        assert want in names, want
    assert all(s.t1 is not None and s.t1 >= s.t0
               for s in tobs.finished_spans())
    tobs.disable()
    tobs.clear_spans()
    store.write("e", {"k": np.arange(40)})
    assert tobs.finished_spans() == []
