"""Autopilot drift demo on the PyTorch/CUDA port, the counterpart of
``examples/autopilot_drift.py``: the service closes the loop on a
shifting mix.

TPC-H-like tables start round-robin.  An orderkey-join query (Q04 family)
runs a few times; the Autopilot observes every run, decides lineitem and
orders should live hash-partitioned on orderkey, repartitions them in
place (a new generation, atomically swapped), and the next run's join
shuffles are elided.  Then the mix *drifts* to a partkey join (Q17
family): the orderkey traffic ages out of the recency window and the
service re-partitions lineitem onto partkey — all deterministically via
``tick()`` with a logical clock.  The device backend (the default here)
keeps the tables on the card and repartitions them there.

Run:  PYTHONPATH=src python examples/torch/autopilot_drift.py          # card
      PYTHONPATH=src python examples/torch/autopilot_drift.py host     # host
      PYTHONPATH=src python examples/torch/autopilot_drift.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.launch.serve import resolve_device
from repro_torch.service import run_drift_scenario


def show(tag, runs):
    for r in runs:
        print(f"  {tag}: shuffles={r.shuffles} elided={r.elided} "
              f"bytes={r.shuffle_bytes} wall={r.wall_s * 1e3:.1f}ms")


def show_tick(tag, tick):
    if not tick.applied:
        print(f"  {tag}: no action (cooldown / below hysteresis)")
    for a in tick.applied:
        s = a.score
        print(f"  {tag}: {a.dataset} -> {a.decision.candidate.signature()} "
              f"gen={a.generation} path={a.path} "
              f"benefit={s.benefit_s * 1e3:.1f}ms/window "
              f"cost={s.repartition_s * 1e3:.1f}ms")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("backend", nargs="?", default="device",
                    choices=("device", "host"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)                  # no card: raises
    rep = run_drift_scenario(backend=args.backend, device=device)

    print(f"== phase A: orderkey mix (backend={args.backend} on {device}, "
          "round-robin layout)")
    show("run", rep.phase_a)
    print("== tick: observe -> decide -> repartition -> swap generation")
    show_tick("decision", rep.tick_a)
    print("== post-decision run (join shuffles elided)")
    show("run", [rep.post_a])

    print("== phase B: mix drifts to partkey joins")
    show("run", rep.phase_b)
    show_tick("early tick", rep.tick_b_mid)
    show_tick("drift tick", rep.tick_b)
    print("== post-drift run")
    show("run", [rep.post_b])

    print("== lineitem layout trajectory")
    for g, p in zip(rep.lineitem_generations, rep.lineitem_partitioners):
        print(f"  generation {g}: {p}")

    for k in rep.result_pre_a:
        np.testing.assert_array_equal(rep.result_pre_a[k],
                                      rep.result_post_a[k])
    for k in rep.result_pre_b:
        np.testing.assert_array_equal(rep.result_pre_b[k],
                                      rep.result_post_b[k])
    print("query results bit-identical across all layout generations ✓")
    return rep


if __name__ == "__main__":
    main()
