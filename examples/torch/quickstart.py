"""Quickstart on the PyTorch/CUDA port: the Lachesis loop via
``lachesis_torch.Session``, the counterpart of ``examples/quickstart.py``.

1. Trace two workloads (a loader and a join) in the DSL.
2. Log historical executions; the advisor (Alg. 3) extracts partitioner
   candidates from the consumer IR and picks one.
3. Store data with the chosen persistent partitioning, on the card.
4. ``session.explain`` shows the compiled PhysicalPlan: both shuffles are
   statically elided (Alg. 4 at plan time); ``session.run`` executes it,
   and a second run is a pure plan-cache hit.
5. Over a round-robin store the shuffles are real, and the device backend
   runs them through the hash-partition kernels.

Run:  PYTHONPATH=src python examples/torch/quickstart.py               # card
      PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""

import argparse

import numpy as np

import lachesis_torch
from repro_torch.core import (HistoryStore, author_integrator,
                              enumerate_candidates, partitioning_creation)
from repro_torch.core.dsl import reddit_loader
from repro_torch.launch.serve import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)   # no card: raises

    # -- 1. workloads --------------------------------------------------------
    loader = reddit_loader("submission-loader", "raw", "submissions", "json")
    consumer = author_integrator()          # joins submissions ⋈ authors

    # -- 2. history + advisor -----------------------------------------------
    cand = enumerate_candidates(consumer.graph, "submissions")[0]
    print("extracted candidate:", cand.signature())  # Listing 2 from Listing 1

    history = HistoryStore()
    for t in range(2):                      # two past runs of the workflow
        history.log_workload(loader, timestamp=100.0 * t, latency=30.0,
                             input_bytes=2e9)
        history.log_workload(consumer, timestamp=100.0 * t + 50,
                             latency=90.0, input_bytes=3e9,
                             candidate_stats={cand.signature(): {
                                 "selectivity": 0.1, "distinct_keys": 1e6}})

    decision = partitioning_creation(loader, "submissions", history,
                                     dataset_bytes=2e9)
    print("advisor picked:", decision.candidate.strategy,
          decision.candidate.signature())

    # -- 3. storage-time partitioning -----------------------------------------
    rng = np.random.default_rng(0)
    subs = {"author": rng.integers(0, 1000, 20_000),
            "score": rng.normal(size=20_000)}
    auths = {"author": np.arange(1000), "karma": rng.normal(size=1000)}

    session = lachesis_torch.Session(num_workers=8, device=device)
    session.write("submissions", subs, decision.candidate)
    session.write("authors", auths,
                  enumerate_candidates(consumer.graph, "authors")[0])

    # -- 4. plan, then execute shuffle-free -------------------------------------
    print(session.explain(consumer))        # both partition nodes: ELIDED
    result = session.run(consumer)
    stats = result.stats
    print(f"join ran with {stats.shuffles_performed} shuffles "
          f"({stats.shuffles_elided} elided, {stats.shuffle_bytes} bytes "
          "moved)")
    assert stats.shuffles_performed == 0
    rerun = session.run(consumer)           # same workload, same layout ⇒ hit
    assert rerun.stats.plan_cache_hit
    print("OK — persistent partitioning made the join local; re-run was a "
          f"pure plan-cache hit ({session.plan_cache_stats()}).")

    # -- 5. the device backend over a round-robin store ------------------------
    # The partition nodes run through the cached single-pass ShufflePlans:
    # the hash-partition kernels on the card, their plain versions on the
    # CPU, bit-identical to the host path.
    dev = lachesis_torch.Session(num_workers=8, backend="device",
                                 device=device)
    dev.write("submissions", subs)
    dev.write("authors", auths)
    dev_stats = dev.run(consumer).stats
    assert dev_stats.device_repartitions == dev_stats.shuffles_performed == 2
    print(f"device backend: {dev_stats.device_repartitions} repartitions ran "
          f"through the ShufflePlan path on {device}.")
    return {"decision": decision, "result": result, "rerun": rerun,
            "dev_stats": dev_stats}


if __name__ == "__main__":
    main()
