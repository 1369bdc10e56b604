#!/usr/bin/env python3
"""Time the bf16 flash-attention backward, with a torch.profiler split of
one call by launch, for the port found under ``--src``, so that two
versions of the port can be compared in turns within one call on one
card:

    python3 scripts/flash_bwd_compare.py                 # this checkout
    python3 scripts/flash_bwd_compare.py --src OTHER/src --tag parent

For each shape of ``chip_smoke.FA_BWD_TIMED`` (internlm2-1.8b's, the
recurrentgemma-9b local layer's, whisper-small's encoder and cross
attention) in bfloat16, on (B, heads, S, hd) views of (B, S, heads, hd)
buffers as phase 5 makes them, it prints one JSON line: ``ms`` (CUDA
events over 10 calls after 3, the 50 MB L2 flushed before each, as phase
5 times it), ``tflops`` (10 * hd FLOPs a kept pair over ``ms``) and
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
    from repro_torch.kernels.cost import flash_attention_bwd_cost
    from repro_torch.kernels.flash_attention import flash_attention as fa

    card = c.card_line()
    fa.LIB.build(True)
    fa.LIB_BWD.build(True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(55)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    rows = []
    for what, shape in c.FA_BWD_TIMED:
        B, H, KV, Sq, Skv, hd, causal, window = shape
        kw = dict(causal=causal, window=window)
        q, k, v, dout = c.fa_bwd_inputs(torch, gen, B, H, KV, Sq, Skv, hd,
                                        torch.bfloat16)
        row = {"what": what, "shape": list(shape)}
        out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)

        def call():
            return fa.flash_attention_backward(q, k, v, out, lse, dout, **kw)
        row["ms"] = c.time_ms(torch, call, flush, reps=10)
        flops, _ = flash_attention_bwd_cost(B, H, KV, Sq, Skv, hd, causal,
                                            window, 2)
        row["tflops"] = flops / row["ms"] / 1e9
        row["split"] = c.bwd_split(torch, call, c.FA_BWD_SPLIT)
        rows.append(row)
        print(f"{args.tag}: {what}: {row['ms']:.4f} ms, "
              f"{row['tflops']:.1f} TFLOP/s, split {row['split']}",
              file=sys.stderr, flush=True)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
