"""Durable telemetry and the regression watchdog of the torch port
(DESIGN §15) against the reference.

A durable session appends one ``RunProfile`` per run under its store root;
its fields (timings aside) must equal the reference's for the same runs,
and survive a reopen.  The watchdog's baseline, regression, dedupe and
re-arm behaviour is held to the reference's signals on the same telemetry,
and the node-metrics export and merged cluster view to the reference's
structure.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import lachesis  # noqa: E402
import lachesis_torch  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.data import device_repartition as jdr  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs.telemetry import RunProfile as JRunProfile  # noqa: E402
from repro.obs.telemetry import TelemetryStore as JTelemetry  # noqa: E402
from repro.obs.watchdog import RegressionDetector as JDetector  # noqa: E402
from repro.service.drivers import drift_tables  # noqa: E402
from repro_torch.data import device_repartition as tdr  # noqa: E402
from repro_torch.obs.metrics import (MetricsRegistry,  # noqa: E402
                                     parse_prometheus_text)
from repro_torch.obs.telemetry import (RunProfile,  # noqa: E402
                                       TELEMETRY_SCHEMA_VERSION,
                                       TelemetryStore)
from repro_torch.obs.watchdog import RegressionDetector  # noqa: E402

BACKENDS = ["host", "device"]
TIMINGS = ("t", "process", "wall_s", "shuffle_s", "io_s", "planning_s")


def _session(pkg, root, backend, **kw):
    if pkg is lachesis:
        return lachesis.Session(backend=backend, store_path=str(root),
                                metrics=JRegistry(), **kw)
    return lachesis_torch.Session(backend=backend, store_path=str(root),
                                  device="cpu", metrics=MetricsRegistry(),
                                  **kw)


def _seed(pkg, root, backend, n=800):
    sess = _session(pkg, root, backend, num_workers=4)
    for name, data in drift_tables(n_lineitem=n, n_orders=200,
                                   n_parts=80).items():
        sess.write(name, data)
    return sess


def _query(core, key="orderkey"):
    wl = core.Workload("telemetry-q")
    t = wl.scan("lineitem")
    p = wl.partition(t[key])
    wl.aggregate(p, reducer="sum")
    return wl


def _join(core):
    wl = core.Workload("telemetry-join")
    li, od = wl.scan("lineitem"), wl.scan("orders")
    j = wl.join(li, od, left_key=li["orderkey"], right_key=od["orderkey"],
                tag="li_orders")
    wl.write(j, "joined")
    return wl


def _fields(profile):
    return {k: v for k, v in profile.to_record().items() if k not in TIMINGS}


def _drive(core, sess):
    """Cold run, warm run, a join that writes (storage I/O), then a
    repartition that makes the next run elide."""
    sess.run(_query(core))
    sess.run(_query(core))
    sess.run(_join(core))
    sess.repartition("lineitem",
                     core.enumerate_candidates(_query(core).graph,
                                               "lineitem")[0])
    sess.run(_query(core))


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_profiles_match_reference_and_survive_reopen(tmp_path, backend):
    jdr.clear_plan_cache()
    tdr.clear_plan_cache()
    js = _seed(lachesis, tmp_path / "ref", backend)
    ts = _seed(lachesis_torch, tmp_path / "port", backend)
    _drive(jcore, js)
    _drive(tcore, ts)
    want, got = js.telemetry(), ts.telemetry()
    assert len(got) == len(want) == 4
    assert all(isinstance(p, RunProfile) for p in got)
    for g, w in zip(got, want):
        assert _fields(g) == _fields(w)
    cold, warm, join, elided = got
    assert not cold.plan_cache_hit and warm.plan_cache_hit
    assert join.io_bytes > 0 and join.output_bytes > 0
    assert (elided.shuffles_elided, elided.shuffles_performed) == (1, 0)
    assert elided.generations["lineitem"] == 1

    # a fresh session over each root reads the history and appends to it
    js2 = _session(lachesis, tmp_path / "ref", backend)
    ts2 = _session(lachesis_torch, tmp_path / "port", backend)
    assert [_fields(p) for p in ts2.telemetry()] == \
        [_fields(p) for p in js2.telemetry()]
    js2.run(_query(jcore))
    ts2.run(_query(tcore))
    assert len(ts2.telemetry()) == 5
    assert _fields(ts2.telemetry(limit=1)[0]) == \
        _fields(js2.telemetry(limit=1)[0])
    # memory-only sessions have no telemetry and say so cheaply
    mem = lachesis_torch.Session(backend=backend, device="cpu")
    assert mem.telemetry() == [] and mem.telemetry_store is None


def test_reference_telemetry_reads_in_port_and_back(tmp_path):
    """The runs.jsonl format is shared: either package reads the other's
    records, and compaction summaries agree."""
    jt = JTelemetry(str(tmp_path / "a"), max_records=10, compact_slack=5)
    tt = TelemetryStore(str(tmp_path / "b"), max_records=10, compact_slack=5)
    for i in range(40):
        kw = dict(t=float(i), workload=f"w{i}", wall_s=1.0 + i % 3,
                  retraces=i % 2, plan_cache_hit=(i % 2 == 0),
                  generations={"d": i})
        jt.record_run(JRunProfile(**kw))
        tt.record_run(RunProfile(**kw))
        if i % 7 == 0:
            jt.record_tick({"tick": i, "t": float(i)})
            tt.record_tick({"tick": i, "t": float(i)})
    assert jt.compactions == tt.compactions >= 1
    assert tt.summary() == jt.summary()
    with open(jt.path) as a, open(tt.path) as b:
        assert a.read() == b.read()
    cross = TelemetryStore(str(tmp_path / "a"), max_records=10)
    assert [_fields(p) for p in cross.run_profiles()] == \
        [_fields(p) for p in jt.run_profiles()]
    back = JTelemetry(str(tmp_path / "b"), max_records=10)
    assert back.summary() == tt.summary()


def test_telemetry_store_appends_reads_and_tolerates_garbage(tmp_path):
    tele = TelemetryStore(str(tmp_path))
    tele.record_run(RunProfile(t=1.0, workload="a", wall_s=0.5))
    tele.record_tick({"tick": 1, "considered": 0})
    tele.record_run(RunProfile(t=2.0, workload="b", wall_s=0.7))
    with open(tele.path, "a") as f:
        f.write(json.dumps({"v": TELEMETRY_SCHEMA_VERSION + 1,
                            "kind": "run", "workload": "future"}) + "\n")
        f.write('{"torn')                     # crash mid-append
    with pytest.warns(UserWarning, match="version"):
        profiles = tele.run_profiles()
    assert [p.workload for p in profiles] == ["a", "b"]
    assert len(tele.records(kind="tick")) == 1
    assert tele.run_profiles(limit=1)[0].workload == "b"
    seqs = [r["seq"] for r in tele.records()
            if r.get("kind") in ("run", "tick")]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)


# ---------------------------------------------------------------------------
# regression watchdog
# ---------------------------------------------------------------------------

def _fill(tele, profile_cls, n, wall, t0=0.0):
    for i in range(n):
        tele.record_run(profile_cls(t=t0 + i, workload="w", wall_s=wall,
                                    padded_bytes=100, valid_bytes=100))


def _signals(sigs):
    return [(s.kind, s.node, s.step, s.detail) for s in sigs]


def _watch(tele_cls, det_cls, profile_cls, reg_cls, root):
    """The reference test's sequence; returns every check's signals."""
    tele = tele_cls(str(root))
    wd = det_cls(tele, window=8, tolerance=1.5, min_runs=4)
    out = []
    _fill(tele, profile_cls, 8, wall=1.0)
    out.append(_signals(wd.check()))
    base = wd.record_baseline()
    out.append(base["stats"])
    for step, (wall, t0) in enumerate(((1.2, 100), (2.0, 200), (2.0, 250),
                                       (1.0, 300), (3.0, 400)), start=1):
        _fill(tele, profile_cls, 8, wall=wall, t0=t0)
        out.append(_signals(wd.check(step=step)))
    out.append(wd.raised_total)
    out.append(_signals(wd.signals()))
    out.append(os.path.exists(wd.baseline_path))
    # lower-is-worse series: a coalesce-rate collapse alerts
    reg = reg_cls()
    c, k = reg.counter("serving_completed"), reg.counter("serving_coalesced")
    c.inc(100), k.inc(80)
    wd2 = det_cls(tele, window=8, tolerance=1.5, min_runs=4, registry=reg)
    wd2.record_baseline()
    c.inc(900)
    out.append(sorted(s.node for s in wd2.check()))
    return out


def test_watchdog_baseline_regression_dedupe_and_rearm(tmp_path):
    got = _watch(TelemetryStore, RegressionDetector, RunProfile,
                 MetricsRegistry, tmp_path / "port")
    want = _watch(JTelemetry, JDetector, JRunProfile, JRegistry,
                  tmp_path / "ref")
    assert got == want
    quiet, base, s1, s2, s3, s4, s5, raised, drained, persisted, names = got
    assert quiet == [] and base["run_wall_p50_s"] == pytest.approx(1.0)
    assert s1 == [] and s3 == [] and s4 == []       # deduped, then re-armed
    (sig,) = s2
    assert sig[:3] == ("perf_regression", "run_wall_p50_s", 2)
    assert sig[3]["ratio"] == pytest.approx(2.0)
    assert s5[0][3]["ratio"] == pytest.approx(3.0)
    assert raised == 2 and persisted
    assert [s[2] for s in drained] == [2, 5]
    assert "coalesce_rate" in names


def test_durable_session_attaches_watchdog(tmp_path):
    sess = _seed(lachesis_torch, tmp_path / "s", "host")
    for _ in range(4):
        sess.run(_query(tcore))
    wd = sess.watchdog
    assert isinstance(wd, RegressionDetector)
    assert wd.telemetry is sess.telemetry_store
    wd.min_runs = 4
    wd.record_baseline()
    _fill(sess.telemetry_store, RunProfile, 32,
          wall=sess.telemetry()[0].wall_s * 10, t0=1e9)
    (sig,) = wd.check(step=1)
    assert sig.node == "run_wall_p50_s"
    snap = sess.metrics()["metrics"]
    assert snap["watchdog_perf_regressions_total"]["samples"][0]["value"] == 1
    assert snap["telemetry_records"]["samples"][0]["value"] >= 36


# ---------------------------------------------------------------------------
# node metrics and the merged view
# ---------------------------------------------------------------------------

def _structure(doc):
    return {name: (series["type"],
                   sorted({tuple(sorted(s["labels"]))
                           for s in series["samples"]}))
            for name, series in doc["metrics"].items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_node_metrics_and_cluster_view_match_reference(tmp_path, backend):
    docs = {}
    for pkg, core in ((lachesis, jcore), (lachesis_torch, tcore)):
        sess = _seed(pkg, tmp_path / pkg.__name__, backend)
        sess.run(_query(core))
        path = sess.export_node_metrics("me")
        assert os.path.basename(path) == "metrics-me.json"
        docs[pkg.__name__] = (sess.cluster_metrics(),
                              sess.cluster_metrics_text())
    (want, want_text), (got, got_text) = docs["lachesis"], \
        docs["lachesis_torch"]
    assert got["version"] == want["version"]
    assert got["nodes"] == want["nodes"] == ["me"]
    assert set(got) == set(want)
    gs, ws = _structure(got), _structure(want)
    # every store, telemetry and watchdog series of the reference is here,
    # shaped the same; the ShufflePlan and tracer series too
    shared = {n for n in ws
              if n.startswith(("store_", "telemetry_", "watchdog_",
                               "shuffleplan_cache_", "planner_", "trace"))}
    assert shared and shared <= set(gs)
    for name in shared:
        assert gs[name] == ws[name], name
    for series in got["metrics"].values():
        for s in series["samples"]:
            assert s["labels"]["node"] == "me"
    parsed = parse_prometheus_text(got_text)
    assert {lab["node"] for _n, lab, _v in parsed["samples"]} == {"me"}
    assert set(parse_prometheus_text(want_text)) == set(parsed)
