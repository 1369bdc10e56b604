"""End-to-end Reddit data-integration scenario on the PyTorch/CUDA port
(paper §5.2.1, Fig. 5, Tab. 3), the counterpart of
``examples/reddit_integration.py``.

Three workloads: load submissions, load authors, join on author.  The
advisor (Alg. 3) picks the keyed candidate from history; w/o Lachesis
both tables are stored round-robin and the join shuffles both sides
(device re-buckets through the hash-partition kernels), w/ Lachesis they
are hash-partitioned on the author key at storage time and the join runs
shuffle-free.  Reports the wall and modelled (10 Gbps) speedups, the
shuffle bytes avoided and the producer-side overhead (Tab. 3) as CSV rows.

Run:  PYTHONPATH=src python examples/torch/reddit_integration.py       # card
      PYTHONPATH=src python examples/torch/reddit_integration.py --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch.api import Session
from repro_torch.core import (HistoryStore, author_integrator,
                              enumerate_candidates, partitioning_creation)
from repro_torch.core.advisor import GreedySelector
from repro_torch.core.dsl import reddit_loader
from repro_torch.data.partition_store import PartitionStore
from repro_torch.launch.serve import resolve_device

NET_BW = 1.25e9      # 10 Gbps, the paper's cluster
#: (name, submissions, authors): the JAX example's two cases
CASES = (("small", 200_000, 50_000), ("large", 1_200_000, 300_000))


def make_data(n_sub, n_auth, seed=0):
    rng = np.random.default_rng(seed)
    subs = {"author": rng.integers(0, n_auth, n_sub).astype(np.int64),
            "score": rng.normal(size=n_sub).astype(np.float32),
            "ups": rng.integers(0, 1000, n_sub).astype(np.int32)}
    auths = {"author": rng.permutation(n_auth).astype(np.int64),
             "karma": rng.normal(size=n_auth).astype(np.float32)}
    return subs, auths


def run_consumer(store, workload, repeats=3):
    """The best of ``repeats`` runs: its wall, its wall plus the shuffle
    bytes at :data:`NET_BW`, its shuffle counters and its values."""
    sess = Session(store, device=store.device)
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        vals, stats = sess.run(workload)
        wall = time.perf_counter() - t0
        if best is None or wall < best[0]:
            best = (wall, stats, vals)
    wall, stats, vals = best
    return {"wall_s": wall,
            "modeled_s": wall + stats.modeled_network_s(NET_BW),
            "shuffle_bytes": stats.shuffle_bytes,
            "shuffles": stats.shuffles_performed,
            "elided": stats.shuffles_elided,
            "device_repartitions": stats.device_repartitions,
            "values": vals}


def advisor_decide(producer, dataset, consumer, cand_sig, *, dataset_bytes,
                   n_history=3):
    """Build history (producer → consumer lineage) and run Alg. 3."""
    hist = HistoryStore()
    for t in range(n_history):
        hist.log_workload(producer, timestamp=100.0 * t, latency=30.0,
                          input_bytes=dataset_bytes)
        hist.log_workload(consumer, timestamp=100.0 * t + 50, latency=90.0,
                          input_bytes=dataset_bytes,
                          candidate_stats={cand_sig: {
                              "selectivity": 0.1, "distinct_keys": 1e6,
                              "num_objects": 1e6}})
    return partitioning_creation(producer, dataset, hist,
                                 selector=GreedySelector(),
                                 dataset_bytes=dataset_bytes)


def emit(name, us_per_call, derived):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def run_case(name, n_sub, n_auth, device, workers=8):
    """One case of Fig. 5 on ``device``: the advisor's decision, the
    round-robin (``base``) and partitioned (``opt``) consumers and the
    speedups."""
    wl = author_integrator()
    subs, auths = make_data(n_sub, n_auth)
    sub_bytes = sum(v.nbytes for v in subs.values())
    sub_cand = enumerate_candidates(wl.graph, "submissions")[0]
    auth_cand = enumerate_candidates(wl.graph, "authors")[0]

    # Alg. 3: the advisor must pick the keyed candidate from history
    loader = reddit_loader("submission-loader", "raw_subs", "submissions",
                           "json")
    decision = advisor_decide(loader, "submissions", wl, sub_cand.signature(),
                              dataset_bytes=sub_bytes)
    assert decision.candidate.is_keyed, "advisor failed to pick keyed"

    # w/o Lachesis: round-robin storage (paper baseline)
    store = PartitionStore(workers, device=device)
    t0 = time.perf_counter()
    store.write("submissions", subs)
    store.write("authors", auths)
    producer_rr = time.perf_counter() - t0
    base = run_consumer(store, wl)

    # w/ Lachesis: the advisor's partitioning, persistent at storage time
    store2 = PartitionStore(workers, device=device)
    t0 = time.perf_counter()
    store2.write("submissions", subs, decision.candidate)
    store2.write("authors", auths, auth_cand)
    producer_part = time.perf_counter() - t0
    opt = run_consumer(store2, wl)
    assert (base["shuffles"], opt["shuffles"], opt["elided"]) == (2, 0, 2), \
        (base["shuffles"], opt["shuffles"], opt["elided"])
    assert base["device_repartitions"] == 2

    speedup_wall = base["wall_s"] / opt["wall_s"]
    speedup_model = base["modeled_s"] / opt["modeled_s"]
    overhead = producer_part / max(producer_rr, 1e-9) - 1.0
    emit(f"reddit_{name}_consumer", opt["wall_s"] * 1e6,
         f"speedup_wall={speedup_wall:.2f}x "
         f"speedup_modeled={speedup_model:.2f}x "
         f"shuffles {base['shuffles']}->{opt['shuffles']} "
         f"elided={opt['elided']} bytes_saved={base['shuffle_bytes']}")
    emit(f"reddit_{name}_producer", producer_part * 1e6,
         f"partition_overhead={overhead * 100:.0f}% (paper Tab.3: <=10%)")
    return {"decision": decision, "base": base, "opt": opt,
            "speedup_wall": speedup_wall, "speedup_model": speedup_model}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)   # no card: raises
    print("name,us_per_call,derived")
    out = {name: run_case(name, n_sub, n_auth, device)
           for name, n_sub, n_auth in CASES}
    sm, lg = out["small"], out["large"]
    print(f"\nSpeedups on {device} — small: {sm['speedup_wall']:.2f}x wall "
          f"({sm['speedup_model']:.2f}x modeled at 10 Gbps); large: "
          f"{lg['speedup_wall']:.2f}x wall ({lg['speedup_model']:.2f}x "
          "modeled).")
    print("Paper (real 10-node cluster): 4.8x small, 14.7x large — the gap "
          "is the single-host substrate; shuffles 2→0 matches exactly.")
    return out


if __name__ == "__main__":
    main()
