"""Time-boxed serving-tier stress smoke on the PyTorch/CUDA port (DESIGN
§11 + §13), the counterpart of ``scripts/serving_stress.py``.

One shared device PartitionStore, CLIENTS concurrent clients hammering a
ServingFrontend while a background thread keeps flipping the scanned
table's layout generation (device-to-device repartitions) and a
background Autopilot ticks on its own daemon thread.  Every result must
be bit-identical to the serial baseline and nothing may fail — the
serial-equivalence guarantee the serving tier is built on, as a
standalone executable assertion.

The whole run is traced (DESIGN §13): at exit it must export one
coherent Chrome-trace JSON — ticket spans parented across the pool
threads, Autopilot ticks on the optimizer thread — plus a metrics
snapshot (JSON + Prometheus text).  Pass an artifacts directory to keep
them.

Usage: python scripts/torch/serving_stress.py [seconds] [clients]
           [artifacts_dir] [--device cpu]
(the card is the default; with no card and no ``--device`` it raises).
Exits 1 on any divergence, error, deadline overrun, or an incoherent
trace.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.api import Session
from repro_torch.core import Workload, enumerate_candidates
from repro_torch.data.partition_store import PartitionStore
from repro_torch.launch.serve import resolve_device
from repro_torch.service import aggregate_result, drift_tables


def query() -> Workload:
    wl = Workload("stress-q")
    li = wl.scan("lineitem")
    od = wl.scan("orders")
    j = wl.join(li, od, left_key=li["orderkey"], right_key=od["orderkey"],
                tag="li_orders")
    wl.aggregate(j, key=j["odate"], reducer="sum")
    return wl


def _check_trace_coherence(doc) -> list:
    """The §13 acceptance checks on the exported Chrome trace: one
    consistent document whose ticket spans parent across the pool
    boundary and whose Autopilot ticks live on the optimizer thread."""
    problems = []
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_id = {e["args"]["span_id"]: e for e in ev}
    tickets = [e for e in ev if e["name"] == "serve.ticket"]
    ticks = [e for e in ev if e["name"] == "autopilot.tick"]
    threads = {e["tid"]: e["args"]["name"]
               for e in doc["traceEvents"] if e.get("ph") == "M"}
    if not tickets:
        problems.append("no serve.ticket spans in trace")
    cross = 0
    for t in tickets:
        parent = by_id.get(t["args"].get("parent_id"))
        if parent is not None and parent["tid"] != t["tid"]:
            cross += 1
    if not cross:
        problems.append("no ticket span parented across the pool handoff")
    if not ticks:
        problems.append("no autopilot.tick spans in trace")
    elif not all("autopilot" in threads.get(e["tid"], "")
                 for e in ticks):
        problems.append("autopilot.tick span not on the optimizer thread")
    flows = [e for e in doc["traceEvents"] if e.get("ph") in ("s", "f")]
    if len([e for e in flows if e["ph"] == "s"]) != \
            len([e for e in flows if e["ph"] == "f"]):
        problems.append("unpaired flow events")
    return problems


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("seconds", nargs="?", type=float, default=20.0)
    parser.add_argument("clients", nargs="?", type=int, default=8)
    parser.add_argument("artifacts_dir", nargs="?", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)                  # no card: raises
    budget_s, n_clients, artifacts = (args.seconds, args.clients,
                                      args.artifacts_dir)

    obs.enable("full")
    store = PartitionStore(num_workers=4, device=device,
                           max_retired_generations=16)
    sess = Session(store)
    for name, data in drift_tables(n_lineitem=3000, n_orders=800,
                                   n_parts=200).items():
        sess.write(name, data)

    want = aggregate_result(sess.run(query()).values, query())
    front = sess.serve(max_workers=n_clients, max_queue=4 * n_clients)
    ap = sess.autopilot()
    ap.start(period_s=0.5)          # ticks on the lachesis-autopilot thread
    cand = enumerate_candidates(query().graph, "lineitem")[0]
    deadline = time.perf_counter() + budget_s
    stop = threading.Event()
    flips = [0]
    errors = []

    def flipper():
        while not stop.is_set():
            store.repartition(store.read("lineitem"), cand, swap=True)
            flips[0] += 1

    def client(cid):
        try:
            while time.perf_counter() < deadline:
                res = front.run(query(), coalesce=bool(cid % 2),
                                timeout=120, block=True)
                got = aggregate_result(res.values, query())
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
        except BaseException as e:      # noqa: BLE001
            errors.append((cid, repr(e)))

    ft = threading.Thread(target=flipper, daemon=True)
    ft.start()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=budget_s + 120)
    stop.set()
    ft.join(60)
    ap.stop()
    stuck = [t for t in threads if t.is_alive()]
    st = front.stats()
    metrics_text = front.metrics_text()
    front.close(wait=not stuck)

    # -- observability artifacts (DESIGN §13) -------------------------------
    doc = sess.export_trace()
    trace_problems = _check_trace_coherence(doc)
    if artifacts:
        os.makedirs(artifacts, exist_ok=True)
        with open(os.path.join(artifacts, "stress_trace.json"), "w") as f:
            json.dump(doc, f)
        sess.metrics_registry.write_snapshot(
            os.path.join(artifacts, "stress_metrics.json"))
        with open(os.path.join(artifacts, "stress_metrics.prom"), "w") as f:
            f.write(metrics_text)
    n_spans = doc["otherData"]["spans"]
    ticks = len(ap.optimizer.reports)

    print(f"serving_stress: device={device} clients={n_clients} "
          f"budget={budget_s}s "
          f"completed={st['completed']} coalesced={st['coalesced']} "
          f"flips={flips[0]} failed={st['failed']} "
          f"autopilot_ticks={ticks} trace_spans={n_spans} "
          f"dropped={doc['otherData']['dropped']}")
    if errors:
        print(f"FAIL: {len(errors)} clients diverged/errored: {errors[:3]}")
        return 1
    if stuck:
        print(f"FAIL: {len(stuck)} clients deadlocked past the deadline")
        return 1
    if st["failed"] or st["completed"] < n_clients:
        print("FAIL: serving counters show failures or vacuous coverage")
        return 1
    if flips[0] < 2:
        print("FAIL: background flipper never ran — stress was vacuous")
        return 1
    if ap.optimizer.last_error is not None:
        print(f"FAIL: autopilot thread died: {ap.optimizer.last_error!r}")
        return 1
    if trace_problems:
        print(f"FAIL: trace incoherent: {trace_problems}")
        return 1
    if "serving_completed" not in metrics_text or \
            "serving_latency_seconds_bucket" not in metrics_text:
        print("FAIL: metrics exposition missing serving series")
        return 1
    print("OK: bit-identical under concurrency + background repartition; "
          "trace + metrics exported coherently")
    return 0


if __name__ == "__main__":
    sys.exit(main())
