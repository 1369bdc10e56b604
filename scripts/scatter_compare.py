#!/usr/bin/env python3
"""Time the ``scatter_perm`` kernel of the port found under ``--src``, so
that two versions of the port can be compared in turns within one call on
one card:

    python3 scripts/scatter_compare.py                 # this checkout's src/
    python3 scripts/scatter_compare.py --src OTHER/src --tag parent

Inputs, 2^26 rows, for m = 32 and m = 256 (m + 1 bins):

* ``padded``: the pids of ``hash_partition_padded`` over 2^26 random keys
  with 60,000,000 valid rows (SF-10 lineitem's shape bucket), as
  ``chip_smoke.py`` phase 2 times them;
* ``one_bin``: every row in bin 0, one bin's prefix chained through every
  tile.

For each it prints one JSON line: the mean ms of ``scatter_perm`` over
``--reps`` launches (CUDA events, the 50 MB L2 flushed before each one),
every launch bit-equal to the plain version, and ``split``: the device ms
of each kernel and memset the call runs, from torch.profiler over
``--reps`` launches (per launch), which splits a multi-pass version into
its passes.  The kernels are built from ``--src``'s sources into that
tree's own ``build/`` directory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 1 << 26
N_VALID = 60_000_000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.hash_partition import hash_partition as hp
    from repro_torch.kernels.hash_partition import ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    hp.LIB.build(True)
    gen = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), dtype=torch.int32,
                         device=dev, generator=gen)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    for m in (32, 256):
        padded = hp.hash_partition_padded(keys, N_VALID, m)
        one = torch.zeros(N, dtype=torch.int32, device=dev)
        one_counts = torch.zeros(m + 1, dtype=torch.int32, device=dev)
        one_counts[0] = N
        for case, (pids, counts) in (("padded", padded),
                                     ("one_bin", (one, one_counts))):
            want = ref.scatter_perm_ref(pids, counts)
            for _ in range(3):
                hp.scatter_perm(pids, counts)
            torch.cuda.synchronize()
            total, equal = 0.0, True
            for _ in range(args.reps):
                flush.zero_()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                got = hp.scatter_perm(pids, counts)
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
                equal &= bool(torch.equal(got, want))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    hp.scatter_perm(pids, counts)
                torch.cuda.synchronize()
            split = {e.key: e.self_device_time_total / 1e3 / args.reps
                     for e in prof.key_averages()
                     if e.self_device_time_total > 0}
            print(json.dumps({"tag": args.tag, "card": card, "m": m,
                              "bins": m + 1, "case": case, "rows": N,
                              "ms": total / args.reps,
                              "bit_equal_to_plain": equal,
                              "split": split}), flush=True)
            if not equal:
                print(f"{args.tag} m={m} {case}: kernel differs from the "
                      "plain version", file=sys.stderr)
                return 1
        del padded, one, want, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
