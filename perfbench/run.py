"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout holding the port under ``src/``.  The
last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last the compared numbers beside their limits under ``checks``); the
compared numbers are also the last lines of standard error.  With no
CUDA card, or fewer than the cell asks for, it prints no result and
exits 3; if the JAX package, JAX or the old harness was loaded, 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
#: build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "build/perfbench_cache/torch_extensions",
          "TRITON_CACHE_DIR": "build/perfbench_cache/triton",
          "CUDA_CACHE_PATH": "build/perfbench_cache/cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for key, rel in CACHES.items():
        os.environ[key] = str(CHECKOUT / rel)
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch
    from perfbench import bench

    cell = bench.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[perfbench] {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench.attach_program(cell)
    out = bench.run(cell, args.seed, args.seconds, bool(args.trace), device,
                    T_START)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"[perfbench] forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 4
    print("\n".join(bench.format_checks(out["checks"])), file=sys.stderr,
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
