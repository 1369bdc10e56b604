#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel against other tile choices.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/flash_tiles.py

Builds ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
as committed and as variants that change one line of its ``Tile`` traits
(into ``build/flash_tiles/``, one nvcc each, all started together), prints
each build's registers and spills for the bf16 hd=128 kernels, holds every
variant to the plain version on phase 5's bf16 cases of ``chip_smoke.py``,
and times each at internlm2-1.8b's prefill shape (B=8, H=16, KV=8, S=4096,
hd=128, causal) in turns (a b c c b a), with SDPA beside them.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MT = "static constexpr int MT = HD == 128 && !CAP ? 2 : 1;"
BK = "static constexpr int BK = HD == 256 ? 32 : 64;"
VARIANTS = {   # name: (trait line as committed, replacement)
    "committed": (MT, MT),
    "16 rows a warp": (MT, "static constexpr int MT = 1;"),
    "32-key tiles": (BK, "static constexpr int BK = HD >= 128 ? 32 : 64;"),
}


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels._build import BUILD_DIR, CudaLibrary
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    if not torch.cuda.is_available():
        return cs.fail("no CUDA device is available")
    src = fa.LIB.source.read_text()
    out = BUILD_DIR.parent / "flash_tiles"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, (name, (old, new)) in enumerate(VARIANTS.items()):
        if old not in src:
            return cs.fail(f"{name}: '{old}' is not in the source")
        path = out / f"flash_tiles_{i}.cu"
        path.write_text(src.replace(old, new))
        libs[name] = CudaLibrary(f"flash_tiles_{i}", path, fa._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        for name, fut in [(n, pool.submit(lib.build, True))
                          for n, lib in libs.items()]:
            fut.result()
            log = libs[name].log.splitlines()
            for j, line in enumerate(log):
                if "flash_fwd_bf16ILi128E" in line and "Compiling" in line:
                    print(f"{name}: {line.split('flash_fwd_bf16')[1][:12]} "
                          + "; ".join(x.strip() for x in log[j + 1:j + 4]
                                      if "spill" in x or "registers" in x),
                          flush=True)
    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def qkv(B, H, KV, Sq, Skv, hd):
        return [torch.randn((B, S, n, hd), generator=gen, device=dev)
                .bfloat16().transpose(1, 2)
                for n, S in ((H, Sq), (KV, Skv), (KV, Skv))]

    cases = [c for c in cs.FLASH_CASES if c[-1] == "bfloat16"]
    B, H, KV, S, hd = cs.FA_MAIN
    q, k, v = qkv(B, H, KV, S, S, hd)
    want = fa_ref.attention_ref(q, k, v, causal=True)
    for name, lib in libs.items():
        fa.LIB = lib
        for case in cases:
            Bc, Hc, KVc, Sq, Skv, hdc, causal, window, cap, _ = case
            kw = dict(causal=causal, window=window, softcap=cap)
            args = qkv(Bc, Hc, KVc, Sq, Skv, hdc)
            cs.check_close(torch, fa.flash_attention(*args, **kw),
                           fa_ref.attention_ref(*args, **kw),
                           cs.TOL["bfloat16"][0], f"{name} {case}")
        rms = cs.rel_rms(torch, fa.flash_attention(q, k, v, causal=True),
                         want)
        if not rms <= cs.RMS_LIMIT:
            return cs.fail(f"{name}: relative RMS error {rms}")
    del want
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    flops = 4.0 * B * H * hd * S * (S + 1) / 2
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        fa.LIB = libs[name]
        times[name].append(cs.time_ms(
            torch, lambda: fa.flash_attention(q, k, v, causal=True), flush))
    sdpa = cs.time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush)
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        runs = ", ".join(f"{t:.4f}" for t in ts)
        print(f"{name}: kernel_ms={ms:.4f} ({runs}) "
              f"kernel_TFLOP/s={flops / ms / 1e9:.1f} on {card}", flush=True)
    print(f"sdpa: library_ms={sdpa:.4f} on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
