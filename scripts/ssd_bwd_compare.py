#!/usr/bin/env python3
"""Time the bf16 SSD backward, with a torch.profiler split of one call by
launch, for the port found under ``--src``, so that two versions of the
port can be compared in turns within one call on one card:

    python3 scripts/ssd_bwd_compare.py                 # this checkout
    python3 scripts/ssd_bwd_compare.py --src OTHER/src --tag parent

For phase 6's table shape (``chip_smoke.SSD_MAIN``: B=8, T=4096, H=32,
P=64, N=128, chunk 256) and mamba2-370m's training shape (B=8, T=2048),
bf16 with fast-decay inputs as phase 6 makes them (x, B and C slices of
one convolution buffer), it prints one JSON line: ``ms`` (CUDA events over
10 calls after 3, the 50 MB L2 flushed before each, as phase 6 times it),
``tflops`` (``kernels/cost.py::ssd_scan_bwd_cost`` over ``ms``) and
``split`` ({launch: device ms} of one call, the kernels keyed by name).
The kernels are built from ``--src``'s sources into that tree's own
``build/`` directory.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (what, (B, T)) at P, N and chunk of chip_smoke.SSD_MAIN
SHAPES = (("table", (8, 4096)), ("mamba2-370m train", (8, 2048)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this checkout")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as c
    from repro_torch.kernels.cost import ssd_scan_bwd_cost
    from repro_torch.kernels.ssd_scan import ssd_scan as ss

    card = c.card_line()
    ss.LIB.build(True)
    ss.LIB_BWD.build(True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(66)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    _, _, H, P, N, L = c.SSD_MAIN
    rows = []
    for what, (B, T) in SHAPES:
        ins = c.ssd_inputs(torch, gen, B, T, H, P, N, torch.bfloat16, "fast")
        gy, gs = c.ssd_bwd_cotangents(torch, gen, ins[0], N)
        row = {"what": what, "shape": [B, T, H, P, N, L]}

        def call():
            return ss.ssd_scan_backward(*ins, gy, gs, L)
        row["ms"] = c.time_ms(torch, call, flush, reps=10)
        flops, _ = ssd_scan_bwd_cost(B, T, H, P, N, L, 2, 4)
        row["tflops"] = flops / row["ms"] / 1e9
        row["split"] = c.bwd_split(torch, call)
        rows.append(row)
        print(f"{args.tag}: {what}: {row['ms']:.4f} ms, "
              f"{row['tflops']:.1f} TFLOP/s, split {row['split']}",
              file=sys.stderr, flush=True)
        del ins, gy, gs
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
