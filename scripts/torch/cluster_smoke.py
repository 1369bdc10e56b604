"""Cross-process cluster smoke test on the PyTorch/CUDA port (DESIGN §14 +
§15 acceptance), the counterpart of ``scripts/cluster_smoke.py``.

Three phases, run as SEPARATE processes sharing one store directory:

    python scripts/torch/cluster_smoke.py write   /path/to/store
    python scripts/torch/cluster_smoke.py crash   /path/to/store
    python scripts/torch/cluster_smoke.py reopen  /path/to/store

(``--device cpu`` on each runs it on the CPU; the card is the default,
and with no card and no ``--device`` the script raises.  A device store
keeps the reassembled columns on the device.)

``write`` (process A): creates a two-node cluster store (directories as
nodes, replication 2), writes datasets sharded across both nodes, runs a
consumer workload (seeding the durable telemetry history), and saves the
expected bits next to the store.

``crash`` (process B): reopens, starts an incremental rebalance onto a
third node, and dies mid-stream — after the first dataset's segments
moved but BEFORE the epoch pointer flipped (``abort_after=1``).  The
"killed" node's partial directory is torn away to simulate losing it.

``reopen`` (process C): a fresh interpreter must recover to the last
consistent epoch (the pre-rebalance placement), read every dataset
bit-identically, then complete a clean rebalance and — after node A's
files are deleted outright — serve everything from the survivors.

Observability (DESIGN §15): each phase traces itself under a process
label, chains onto the previous phase's serialized ``TraceContext``
(persisted under ``<store>/telemetry/``), spills its spans — the crash
phase from *inside* the dying rebalance, so the open ``cluster.rebalance``
span survives — and exports its metrics registry as a per-node snapshot.
The reopen phase then stitches everything into ONE Perfetto-loadable
trace (``telemetry/cluster_trace.json``) plus a merged node-labeled
metrics view (``cluster_metrics.json`` / ``.prom``) and machine-checks
both: spans from all three processes under one trace, paired flow
events across each process boundary, the crashed rebalance flagged
``incomplete``, and per-run telemetry records surviving both restarts.

Exit code 0 on success, 1 with a reason on any violated invariant.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

import repro_torch.obs as obs
from repro_torch.api import Session
from repro_torch.cluster import ClusterConfig, RebalanceAborted
from repro_torch.core import Workload
from repro_torch.launch.serve import resolve_device

NUM_WORKERS = 8
NODES = ("node-a", "node-b")
DATASETS = ("events", "metrics")
PHASES = ("write", "crash", "reopen")


def expected_path(root: str) -> str:
    return os.path.join(root, "smoke_expected.npz")


def fail(msg: str):
    print(f"CLUSTER SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def canonical(store, name):
    return {k: np.asarray(v) for k, v in store.read(name).gather().items()}


def check_bits(store, expected):
    for name in DATASETS:
        got = canonical(store, name)
        for col, want in expected[name].items():
            if not np.array_equal(got[col], want):
                fail(f"{name}.{col} is not bit-identical after reopen")


def consumer() -> Workload:
    wl = Workload("cluster-smoke-q")
    t = wl.scan("events")
    p = wl.partition(t["k"])
    wl.aggregate(p, reducer="sum")
    return wl


def phase_write(root: str, device) -> None:
    rng = np.random.default_rng(14)
    sess = Session(store_path=root, num_workers=NUM_WORKERS, device=device,
                   cluster=ClusterConfig(nodes=NODES, replication=2))
    tele = sess.telemetry_store
    with obs.span("cluster_smoke.write", "smoke"):
        # persist our context NOW: the next phase (another process)
        # attaches to it through the wire carrier
        tele.save_trace_context(obs.TRACER.context(), "write")
        expected = {}
        for name in DATASETS:
            data = {"k": rng.integers(0, 997, 4000).astype(np.int64),
                    "v": rng.standard_normal(4000).astype(np.float32)}
            sess.store.write(name, data)
            expected[name] = canonical(sess.store, name)
        for node in NODES:
            if not os.path.isdir(os.path.join(root, "nodes", node)):
                fail(f"{node} holds no segments after the sharded persist")
        if sess.store.placement_epoch != 0:
            fail(f"fresh store should sit at epoch 0, got "
                 f"{sess.store.placement_epoch}")
        # seed the durable telemetry: one consumer run = one RunProfile
        sess.run(consumer())
        if len(sess.telemetry()) < 1:
            fail("run produced no telemetry RunProfile record")
        np.savez(expected_path(root),
                 **{f"{n}/{c}": v for n, cols in expected.items()
                    for c, v in cols.items()})
    obs.spill_spans(tele.dir, "write")
    sess.export_node_metrics("write")
    print(f"cluster smoke write OK on {device}: {len(DATASETS)} datasets "
          f"over {len(NODES)} nodes, epoch 0, "
          f"{len(sess.telemetry())} telemetry record(s)")


def phase_crash(root: str, device) -> None:
    sess = Session(store_path=root, num_workers=NUM_WORKERS, device=device)
    if not sess.store.is_cluster:
        fail("reopen did not detect the cluster store")
    tele = sess.telemetry_store
    ctx = tele.load_trace_context("write")
    if ctx is None:
        fail("write phase left no trace-context carrier")
    with obs.TRACER.attach(ctx):
        with obs.span("cluster_smoke.crash", "smoke"):
            tele.save_trace_context(obs.TRACER.context(), "crash")
            plan = sess.plan_rebalance(add_nodes=("node-c",),
                                       reason="smoke-crash")
            if plan.partitions_moved <= 0:
                fail("scale-out plan moved no partitions")

            def on_abort():
                # the process "dies" here: spill with the
                # cluster.rebalance span still OPEN on the stack, the
                # way a crash handler would
                obs.spill_spans(tele.dir, "crash")
                sess.export_node_metrics("crash")

            try:
                sess.rebalance(plan=plan, abort_after=1, on_abort=on_abort)
            except RebalanceAborted as e:
                print(f"cluster smoke crash OK: {e}")
            else:
                fail("abort_after=1 did not abort before the epoch commit")
    # no spill after this point: the crash dump above IS this process's
    # trace, exactly as if the interpreter never got further
    if sess.store.placement_epoch != 0:
        fail("aborted rebalance must leave the epoch unflipped")
    # the new node dies mid-rebalance: its half-streamed segments vanish
    shutil.rmtree(os.path.join(root, "nodes", "node-c"),
                  ignore_errors=True)


def check_cluster_trace(doc) -> None:
    """Machine check over the stitched trace: spans from all three
    processes under one document, paired flows (every ``s`` has its
    ``f``) including one cross-process arrow per phase boundary, and the
    crashed rebalance present as an ``incomplete`` complete-event."""
    other = doc.get("otherData", {})
    procs = other.get("processes", {})
    if set(procs) != set(PHASES):
        fail(f"merged trace has processes {sorted(procs)}, want {PHASES}")
    events = doc.get("traceEvents", [])
    by_pid = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_pid.setdefault(ev["pid"], []).append(ev)
    for proc, pid in procs.items():
        if not by_pid.get(pid):
            fail(f"no spans from process {proc!r} in the merged trace")
    starts = [ev for ev in events if ev.get("ph") == "s"]
    finishes = [ev for ev in events if ev.get("ph") == "f"]
    if len(starts) != len(finishes):
        fail(f"unpaired flows: {len(starts)} starts, "
             f"{len(finishes)} finishes")
    if {ev["id"] for ev in starts} != {ev["id"] for ev in finishes}:
        fail("flow start/finish ids do not pair up")
    cross = other.get("cross_process_flows", 0)
    if cross < 2:      # write→crash and crash→reopen at minimum
        fail(f"expected >= 2 cross-process flows, got {cross}")
    # each cross-process arrow must actually span two pids
    xproc = [ev for ev in starts if ev.get("name") == "xproc"]
    fin_by_id = {ev["id"]: ev for ev in finishes}
    for ev in xproc:
        if fin_by_id[ev["id"]]["pid"] == ev["pid"]:
            fail("cross-process flow starts and finishes on one pid")
    # the crashed rebalance survived as an incomplete span
    reb = [ev for ev in events
           if ev.get("ph") == "X" and ev.get("name") == "cluster.rebalance"
           and ev.get("args", {}).get("incomplete")
           and ev.get("args", {}).get("process") == "crash"]
    if not reb:
        fail("open cluster.rebalance span from the crash is missing")
    if other.get("incomplete", 0) < 1:
        fail("merged trace reports no incomplete spans")


def phase_reopen(root: str, device) -> None:
    with np.load(expected_path(root)) as z:
        expected = {}
        for key in z.files:
            name, col = key.split("/", 1)
            expected.setdefault(name, {})[col] = z[key]

    sess = Session(store_path=root, num_workers=NUM_WORKERS, device=device)
    tele = sess.telemetry_store
    ctx = tele.load_trace_context("crash")
    if ctx is None:
        fail("crash phase left no trace-context carrier")
    res = None
    with obs.TRACER.attach(ctx):
        with obs.span("cluster_smoke.reopen", "smoke"):
            tele.save_trace_context(obs.TRACER.context(), "reopen")
            store = sess.store
            if store.placement_epoch != 0:
                fail(f"recovery must land on the pre-crash epoch 0, got "
                     f"{store.placement_epoch}")
            if set(store.directory.nodes) != set(NODES):
                fail(f"recovered membership {store.directory.nodes} != "
                     f"{NODES}")
            check_bits(store, expected)

            # the interrupted scale-out now completes cleanly...
            res = sess.rebalance(add_nodes=("node-c",), reason="smoke-retry")
            if res.epoch != 1:
                fail(f"clean rebalance should commit epoch 1, "
                     f"got {res.epoch}")
            total = sum(float(store.read(n).padded_bytes) for n in DATASETS)
            bound = res.partitions_moved / NUM_WORKERS * total
            if res.bytes_moved > bound + 1e-9:
                fail(f"incremental bound violated: moved {res.bytes_moved} "
                     f"B > {bound:.0f} B ({res.partitions_moved}/"
                     f"{NUM_WORKERS} of {total:.0f} B)")
            check_bits(store, expected)

            # ...and losing a whole original node leaves every partition
            # served
            del sess, store
            shutil.rmtree(os.path.join(root, "nodes", "node-a"))
            sess2 = Session(store_path=root, num_workers=NUM_WORKERS,
                            device=device)
            if sess2.store.placement_epoch != 1:
                fail("post-rebalance reopen lost the committed epoch")
            check_bits(sess2.store, expected)

            # durable telemetry: the write phase's RunProfile must still
            # be here, and this process's run must append beside it
            sess2.run(consumer())
            profiles = sess2.telemetry()
            if len(profiles) < 2:
                fail(f"telemetry lost records across restarts: "
                     f"{len(profiles)} < 2")
            seen = {p.process for p in profiles}
            if not {"write", "reopen"} <= seen:
                fail(f"telemetry processes {sorted(seen)} missing a phase")
    obs.spill_spans(tele.dir, "reopen")
    sess2.export_node_metrics("reopen")

    # stitch the three per-process spills into ONE trace + machine-check
    trace_path = os.path.join(tele.dir, "cluster_trace.json")
    doc = obs.write_merged_trace(trace_path, tele.dir,
                                 metadata={"smoke": "cluster"})
    check_cluster_trace(doc)

    # merged node-labeled metrics view, strictly parseable
    merged = sess2.cluster_metrics()
    if set(merged.get("nodes", [])) != set(PHASES):
        fail(f"cluster metrics merged nodes {merged.get('nodes')} != "
             f"{PHASES}")
    text = sess2.cluster_metrics_text()
    parsed = obs.parse_prometheus_text(text)      # raises on violations
    nodes_seen = {lab.get("node") for _n, lab, _v in parsed["samples"]
                  if "node" in lab}
    if not set(PHASES) <= nodes_seen:
        fail(f"node labels {sorted(nodes_seen)} missing a phase")
    with open(os.path.join(tele.dir, "cluster_metrics.json"), "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
    with open(os.path.join(tele.dir, "cluster_metrics.prom"), "w") as f:
        f.write(text)

    print(f"cluster smoke reopen OK on {device}: epoch "
          f"{sess2.store.placement_epoch}, "
          f"moved {res.partitions_moved}/{NUM_WORKERS} partitions "
          f"({res.bytes_moved} B ≤ {bound:.0f} B bound), survivors serve "
          f"bit-identically; stitched trace "
          f"{doc['otherData']['spans']} spans / "
          f"{doc['otherData']['cross_process_flows']} cross-process flows "
          f"/ {doc['otherData']['incomplete']} incomplete -> {trace_path}; "
          f"{len(profiles)} telemetry records across 3 processes")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=PHASES)
    ap.add_argument("root")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)                  # no card: raises
    # full tracing under the phase's process label: the merge step needs
    # each spill to identify which process its spans came from
    obs.enable("full", process=args.phase)
    {"write": phase_write, "crash": phase_crash,
     "reopen": phase_reopen}[args.phase](args.root, device)


if __name__ == "__main__":
    main()
