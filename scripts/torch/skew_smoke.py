"""Skew-adaptive partitioning smoke on the PyTorch/CUDA port (DESIGN
§12), the counterpart of ``scripts/skew_smoke.py``.

End-to-end over the whole skew loop, as a standalone executable
assertion: Zipf-keyed tables land in an adaptive device store, the
Autopilot's first tick applies the classic keyed repartition, and the
second tick — under injected calibrations that make padding expensive and
shuffles cheap — must fire a hot-key salt, shrink the padded layout, and
keep every consumer result bit-identical.  A rebucket-only pass (salting
disabled) must do the same through the local capacity-map rewrite.

Usage: python scripts/torch/skew_smoke.py [--device cpu]
(the card is the default; with no card and no ``--device`` it raises).
Exits 1 with a reason on any divergence or missing skew action.
"""

import argparse
import sys

import numpy as np

from repro_torch.api import Session
from repro_torch.data.partition_store import PartitionStore
from repro_torch.launch.serve import resolve_device
from repro_torch.service import (Autopilot, AutopilotConfig, LogicalClock,
                                 aggregate_result, drift_tables, q_orderkey)


def fail(msg: str):
    print(f"SKEW SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def scenario(kind: str, device, **cfg_kw) -> str:
    tables = drift_tables(n_lineitem=6000, skew=1.5)
    store = PartitionStore(num_workers=8, device=device)
    for name, data in tables.items():
        store.write(name, data)
    sess = Session(store)
    ap = Autopilot(sess, clock=LogicalClock(),
                   config=AutopilotConfig(min_runs=2.0, hysteresis=0.5,
                                          cooldown_ticks=0,
                                          skew_actions=True, **cfg_kw))
    wl = q_orderkey()
    for _ in range(3):
        sess.run(wl)
    vals, _ = sess.run(wl)
    ref = aggregate_result(vals, wl)

    # calibration sweet spot: shuffles cheap, padding (storage I/O) dear
    ap.cost_model.observe_shuffle(1e9, 0.1)
    ap.cost_model.observe_io(1e6, 1.0)

    ap.tick()                                 # keyed repartition
    ds = store.read("lineitem")
    if not ds.skew() >= 2.0:
        fail(f"{kind}: lineitem's skew {ds.skew()} is below 2")
    waste = ds.padding_waste()
    if not waste > 0:
        fail(f"{kind}: the keyed layout wastes no padding")

    rep = ap.tick()                           # the skew action under test
    kinds = {(a.dataset, a.kind) for a in rep.applied}
    if ("lineitem", kind) not in kinds:
        fail(f"no {kind} of lineitem was applied: {kinds}")
    ds2 = store.read("lineitem")
    if not ds2.padding_waste() < waste:
        fail(f"{kind}: padding {ds2.padding_waste()} did not shrink from "
             f"{waste}")

    vals2, _ = sess.run(wl)
    got = aggregate_result(vals2, wl)
    for k in ref:
        if not np.array_equal(got[k], ref[k]):
            fail(f"{kind}: column {k} differs after the {kind}")
    return (f"{kind}: waste {waste} -> {ds2.padding_waste()} bytes, "
            f"skew {ds.skew():.2f} -> {ds2.skew():.2f}, results identical")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)   # no card: raises
    print("skew_smoke:", scenario("salt", device))
    print("skew_smoke:", scenario("rebucket", device, hot_key_fraction=2.0))
    print(f"skew_smoke: OK on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
