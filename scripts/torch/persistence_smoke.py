"""Cross-process persistence smoke test on the PyTorch/CUDA port (DESIGN
§10 acceptance scenario), the counterpart of ``scripts/persistence_smoke.py``.

Two phases, run as SEPARATE processes sharing one store directory:

    python scripts/torch/persistence_smoke.py write  /path/to/store
    python scripts/torch/persistence_smoke.py reopen /path/to/store

(``--device cpu`` on either runs it on the CPU; the card is the default,
and with no card and no ``--device`` the script raises.)

``write`` (process A): builds a round-robin dataset in a device store,
runs the consumer workload under an attached Autopilot until it applies
the hash layout the workload wants (device to device), and saves the run's
result table next to the store.

``reopen`` (process B): a fresh interpreter reattaches via
``Session(store_path=...)``, runs the same consumer, and asserts

* the partition node is ELIDED (zero shuffles performed, zero bytes), and
* the result is bit-identical to process A's saved table —

i.e. the paper's headline: a second application rides the partitioning a
previous application paid for.  The on-disk format is the JAX package's,
so either package's ``reopen`` takes the other's ``write``.  Exit code 0
on success, 1 with a reason on any violated invariant.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from repro_torch.api import Session
from repro_torch.core import Workload
from repro_torch.core.executor import TableVal
from repro_torch.launch.serve import resolve_device
from repro_torch.service.observer import LogicalClock

NUM_WORKERS = 4
N_ROWS = 20_000


def consumer() -> Workload:
    wl = Workload("smoke-consumer")
    t = wl.scan("events")
    p = wl.partition(t["k"])
    wl.aggregate(p, reducer="sum")
    return wl


def final_table(res) -> TableVal:
    return [v for v in res.values.values() if isinstance(v, TableVal)][-1]


def expected_path(store_dir: str) -> str:
    return os.path.join(store_dir, "smoke_expected.npz")


def fail(msg: str):
    print(f"PERSISTENCE SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_write(store_dir: str, device) -> None:
    rng = np.random.default_rng(7)
    data = {"k": rng.integers(0, 257, size=N_ROWS).astype(np.int64),
            "v": rng.standard_normal(N_ROWS).astype(np.float32)}
    sess = Session(store_path=store_dir, num_workers=NUM_WORKERS,
                   device=device)
    sess.write("events", data)              # round-robin: the "wrong" layout
    ap = sess.autopilot(clock=LogicalClock())

    first = sess.run(consumer())
    if first.stats.shuffles_performed != 1:
        fail(f"expected the first run to shuffle once, got "
             f"{first.stats.shuffles_performed}")
    sess.run(consumer())
    report = ap.tick()
    if [d.dataset for d in report.applied] != ["events"]:
        fail(f"Autopilot did not apply the events layout: {report.applied}")

    res = sess.run(consumer())
    if res.stats.shuffles_elided != 1 or res.stats.shuffles_performed != 0:
        fail("post-apply run did not elide its shuffle")
    table = final_table(res)
    np.savez(expected_path(store_dir),
             counts=np.asarray(table.counts),
             **{f"col_{k}": np.asarray(v) for k, v in table.columns.items()})
    decisions = sess.store.durable.decisions()
    print(f"phase A OK on {device}: layout {decisions[-1]['candidate']!r} "
          f"applied at gen {decisions[-1]['generation']} "
          f"({report.applied[0].path}), expected table saved "
          f"({table.num_rows} rows)")


def phase_reopen(store_dir: str, device) -> None:
    sess = Session(store_path=store_dir, device=device)
    if sess.num_workers != NUM_WORKERS:
        fail(f"catalog worker count not adopted: {sess.num_workers}")
    stored = sess.read("events")
    if stored.partitioner is None or not stored.partitioner.is_keyed:
        fail("reopened dataset lost its keyed partitioner identity")

    res = sess.run(consumer())
    if res.stats.shuffles_elided != 1:
        fail(f"reopened session did not elide the shuffle "
             f"(elided={res.stats.shuffles_elided})")
    if res.stats.shuffles_performed != 0 or res.stats.shuffle_bytes != 0:
        fail(f"reopened session still shuffled: "
             f"performed={res.stats.shuffles_performed} "
             f"bytes={res.stats.shuffle_bytes}")

    table = final_table(res)
    want = np.load(expected_path(store_dir))
    if not np.array_equal(want["counts"], np.asarray(table.counts)):
        fail("per-worker counts differ from process A")
    for k, v in table.columns.items():
        w = want[f"col_{k}"]
        got = np.asarray(v)
        if w.dtype != got.dtype or not np.array_equal(w, got):
            fail(f"column {k!r} not bit-identical to process A")
    print(f"phase B OK on {device}: fresh process elided its shuffle "
          f"(0 shuffle bytes) and reproduced process A's "
          f"{table.num_rows}-row result bit-identically")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=("write", "reopen"))
    ap.add_argument("store_dir")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)                  # no card: raises
    if args.phase == "write":
        phase_write(args.store_dir, device)
    else:
        phase_reopen(args.store_dir, device)


if __name__ == "__main__":
    main()
