#!/usr/bin/env python3
"""Time the bf16 SSD kernel and measure mamba2-370m's bf16 accuracy, for
the port found under ``--src``, so that two versions of the port can be
compared in turns within one call on one card:

    python3 scripts/ssd_compare.py                 # this checkout's src/
    python3 scripts/ssd_compare.py --src OTHER/src --tag parent

It prints one JSON line:

* ``ssd_ms``: ``ssd_scan`` at mamba2-370m's prefill shape (B=8, T=4096,
  H=32, P=64, N=128, chunk 256, bf16, fast-decay inputs as in
  ``chip_smoke.py`` phase 6), CUDA events, L2 flushed before each launch;
* ``decode_vs_prefill``: the bf16 model (48 layers, seeded random
  weights, batch 8, prompt 4096) decodes greedy tokens; at steps 0, 1 and
  31 the max abs difference between the step's logits and those of a
  prefill over the prompt and the tokens so far, as a share of the
  prefill logits' max-abs (the check of ``chip_smoke.py`` phase 8);
* ``prefill_vs_f32``: the bf16 prefill's logits against a float32 prefill
  of the same weights (upcast), as the same share: how far the bf16 path
  is from float32 arithmetic.

The kernels are built from ``--src``'s sources into that tree's own
``build/`` directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
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
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.models import transformer as T

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ss.LIB.build(True)

    # the kernel alone, fast-decay inputs as chip_smoke.py phase 6
    gen = torch.Generator(device=dev).manual_seed(6)
    B, Tn, H, P, N, L = 8, 4096, 32, 64, 128, 256
    conv = torch.randn((B, Tn, H * P + 2 * N), generator=gen, device=dev)
    conv[..., :H * P] *= 0.5
    conv[..., H * P:] *= 0.3
    conv = conv.bfloat16()
    x = conv[..., :H * P].reshape(B, Tn, H, P)
    dt = torch.nn.functional.softplus(
        torch.randn((B, Tn, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.3)
    kargs = (x, dt, A, conv[..., H * P:H * P + N], conv[..., H * P + N:], L)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    for _ in range(3):
        ss.ssd_scan(*kargs)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(10):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ss.ssd_scan(*kargs)
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    ssd_ms = total / 10
    del kargs, conv, x, dt, flush
    torch.cuda.empty_cache()

    # the model: decode against prefill, and bf16 prefill against float32
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              param_dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 4096), dtype=np.int32)).to(dev)
    V = cfg.vocab_size

    def share(got, ref):
        got, ref = got[:, :V].float(), ref[:, :V].float()
        return float((got - ref).abs().max() / ref.abs().max())

    drift = {}
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, prompts, cache_len=4096 + 32)
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        p32 = _tree(params, lambda t: t.float())
        logits32, _ = T.prefill(cfg32, p32, prompts)
        vs_f32 = share(logits, logits32)
        del p32, logits32
        toks = []
        for i in range(32):
            tok = torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)
            toks.append(tok)
            logits, cache = T.decode_step(cfg, params, cache, tok, 4096 + i)
            if i in (0, 1, 31):
                ref, _ = T.prefill(cfg, params,
                                   torch.cat([prompts] + toks, 1))
                drift[i] = share(logits, ref)
    print(json.dumps({"tag": args.tag, "card": card, "ssd_ms": ssd_ms,
                      "decode_vs_prefill": drift,
                      "prefill_vs_f32": vs_f32}), flush=True)
    return 0


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(v, fn) for v in tree]
    return fn(tree)


if __name__ == "__main__":
    sys.exit(main())
