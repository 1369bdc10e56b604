#!/usr/bin/env python3
"""Where a tile of the single-pass ``scatter_perm`` kernel spends its time.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 scripts/scatter_variants.py

Builds ``src/repro_torch/kernels/hash_partition/csrc/hash_partition.cu``
as committed and as two variants (into ``build/scatter_variants/``, one
nvcc each, all started together):

* ``no look-back``: every tile takes its predecessor's counts as its
  prefix without waiting for them.  Its dests are wrong; it is timed only,
  to price the look-back.
* ``phases``: the committed kernel with thread 0 of every CTA writing the
  global timer after each step (load, histogram and publication, ranking,
  look-back, dest) and how many tiles back its look-back stopped.

At 2^26 rows (m = 32 and 256, the padded pids of ``chip_smoke.py`` phase
2, and m = 32 with all rows in one bin) it times the committed kernel and
the no-look-back variant in turns (a b b a; CUDA events, the 50 MB L2
flushed before each launch) and prints, per input, one JSON line with the
times and the phases' mean and 90th percentile in microseconds, the tiles
alive at once and the look-back distances.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N = 1 << 26
N_VALID = 60_000_000
STAMPS = 8                       # six times, the look-back distance, spare

TIMER = """namespace {
__device__ unsigned long long* g_phases = nullptr;
__device__ __forceinline__ void stamp(int64_t tile, int k) {
  if (g_phases && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_phases[tile * 8 + k] = t;
  }
}
"""
# (text as committed, replacement): each must occur once
PHASES = [
    ("namespace {\n", TIMER),
    ("  const int rows = (int)min((int64_t)kTileRows, n - start);\n\n"
     "  // 1. stage",
     "  const int rows = (int)min((int64_t)kTileRows, n - start);\n"
     "  stamp(tile, 0);\n\n  // 1. stage"),
    ("  __syncthreads();\n\n  // 2. each warp's histogram",
     "  __syncthreads();\n  stamp(tile, 1);\n\n  // 2. each warp's histogram"),
    ("  // 3. stable rank inside", "  stamp(tile, 2);\n  // 3. stable rank inside"),
    ("  // 4. the tile's prefix per bin",
     "  stamp(tile, 3);\n  // 4. the tile's prefix per bin"),
    ("  // 5. dest, 32 consecutive", "  stamp(tile, 4);\n  // 5. dest, 32 consecutive"),
    ("(packed >> kKeyBits) : 0;\n  }\n}",
     "(packed >> kKeyBits) : 0;\n  }\n  stamp(tile, 5);\n}"),
    ("  for (int b = threadIdx.x; b < bins; b += kTileThreads)\n"
     "    s_excl[b] = load_relaxed",
     "  if (g_phases && threadIdx.x == 0) g_phases[tile * 8 + 6] = tile - stop;\n"
     "  for (int b = threadIdx.x; b < bins; b += kTileThreads)\n"
     "    s_excl[b] = load_relaxed"),
    ('extern "C" {\n',
     'extern "C" {\nint hp_set_phases(void* p) {\n'
     '  return (int)cudaMemcpyToSymbol(g_phases, &p, sizeof(p));\n}\n'),
]
VARIANTS = {
    "committed": [],
    "no look-back": [("  int64_t stop = -1;", "  int64_t stop = tile - 1;")],
    "phases": PHASES,
}
PHASE_NAMES = ["load", "histogram+publish", "rank", "look-back", "dest"]


def build(name, edits, out_dir, nvcc, flags):
    src = (ROOT / "src/repro_torch/kernels/hash_partition/csrc"
           / "hash_partition.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old[:40]!r} is not in the source "
                               "exactly once")
        src = src.replace(old, new)
    stem = name.replace(" ", "_").replace("-", "_")
    cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
    cu.write_text(src)
    proc = subprocess.run([nvcc, *flags, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hp_scatter_perm.argtypes = [p, p, p, p, i64, i32, p]
    lib.hp_scatter_perm.restype = i32
    lib.hp_scatter_scratch_bytes.argtypes = [i64, i32]
    lib.hp_scatter_scratch_bytes.restype = i64
    if name == "phases":
        lib.hp_set_phases.argtypes = [p]
        lib.hp_set_phases.restype = i32
    return lib


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, nvcc
    from repro_torch.kernels.hash_partition import hash_partition as hp
    from repro_torch.kernels.hash_partition import ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out_dir = BUILD_DIR.parent / "scatter_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futs = {k: pool.submit(build, k, v, out_dir, nvcc(), NVCC_FLAGS)
                for k, v in VARIANTS.items()}
        libs = {k: f.result() for k, f in futs.items()}
    dev = torch.device("cuda")

    def run(lib, pids, counts):
        n, bins = pids.numel(), counts.numel()
        dest = torch.empty(n, dtype=torch.int32, device=dev)
        scratch = torch.empty(int(lib.hp_scatter_scratch_bytes(n, bins)),
                              dtype=torch.uint8, device=dev)
        err = lib.hp_scatter_perm(pids.data_ptr(), counts.data_ptr(),
                                  dest.data_ptr(), scratch.data_ptr(), n,
                                  bins, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"scatter_perm launch failed: cudaError {err}")
        return dest

    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)

    def time_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / reps

    gen = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), dtype=torch.int32,
                         device=dev, generator=gen)
    for m, case in ((32, "padded"), (32, "one_bin"), (256, "padded")):
        if case == "padded":
            pids, counts = hp.hash_partition_padded(keys, N_VALID, m)
        else:
            pids = torch.zeros(N, dtype=torch.int32, device=dev)
            counts = torch.zeros(m + 1, dtype=torch.int32, device=dev)
            counts[0] = N
        want = ref.scatter_perm_ref(pids, counts)
        for name in ("committed", "phases"):
            if not torch.equal(run(libs[name], pids, counts), want):
                raise AssertionError(f"{name} m={m} {case}: differs from "
                                     "the plain version")
        times = {k: [] for k in ("committed", "no look-back")}
        for name in ("committed", "no look-back", "no look-back",
                     "committed"):
            times[name].append(time_ms(
                lambda: run(libs[name], pids, counts)))
        n_tiles = -(-N // hp.SCATTER_TILE_ROWS)
        stamps = torch.zeros(n_tiles * STAMPS, dtype=torch.int64, device=dev)
        libs["phases"].hp_set_phases(stamps.data_ptr())
        flush.zero_()
        torch.cuda.synchronize()
        run(libs["phases"], pids, counts)
        torch.cuda.synchronize()
        st = stamps.view(n_tiles, STAMPS).cpu().numpy().astype(np.float64)
        t = st[:, :6] - st[:, 0].min()
        phase_us = np.diff(t, axis=1) / 1e3
        grid = np.linspace(0, t[:, 5].max(), 41)[4:37]
        alive = [int(((t[:, 0] <= x) & (t[:, 5] > x)).sum()) for x in grid]
        print(json.dumps({
            "card": card, "m": m, "bins": m + 1, "case": case, "rows": N,
            "ms": times,
            "span_us": float(t[:, 5].max() / 1e3),
            "phase_mean_us": dict(zip(PHASE_NAMES,
                                      phase_us.mean(0).round(3).tolist())),
            "phase_p90_us": dict(zip(PHASE_NAMES, np.percentile(
                phase_us, 90, axis=0).round(3).tolist())),
            "tile_life_mean_us": float((t[:, 5] - t[:, 0]).mean() / 1e3),
            "tiles_alive_mean": float(np.mean(alive)),
            "look_back_tiles_p10_p50_p90": np.percentile(
                st[1:, 6], [10, 50, 90]).tolist(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
