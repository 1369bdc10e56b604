"""Read the numbers that decide ``correct`` over many seeds, for setting a
cell's limits: the port's on every seed, and on the first
``--controls`` seeds the float8 control's and each planted fault's,
all in one process (no measured window).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --controls 3 [--out calib.jsonl]

Each seed prints one JSON line; the last line sums them up: for each
number the largest reading of the port and the smallest of the control
and of each fault.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from perfbench import bench
    if not torch.cuda.is_available():
        print("[calibrate] no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = bench.attach_program(bench.load_cell(args.workload))
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {}
    lines = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        got = cell.driver.calibrate(cell, seed, device, i < args.controls)
        line = {"workload": args.workload, "seed": seed,
                "seconds": time.perf_counter() - t0, **got}
        lines.append(line)
        print(json.dumps(line), flush=True)
        for kind, gaps in got.items():
            if kind.startswith("worst"):
                continue
            for name, v in gaps.items():
                key = f"{kind}.{name}"
                pick = max if kind == "program" else min
                summary[key] = v if key not in summary else pick(
                    summary[key], v)
    total = {"workload": args.workload, "summary": summary,
             "card": torch.cuda.get_device_name(device)}
    print(json.dumps(total), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines + [total]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
