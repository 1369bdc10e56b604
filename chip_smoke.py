#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Lachesis on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

0. card and versions;
1. build the three kernel families from ``src/`` with nvcc, one process
   each, all started together;
2. hold each hash-partition kernel against its plain torch version on the
   card, bit for bit, at the main path's shapes (2^26 keys, the shape
   bucket of 60,000,000 rows) and at edge shapes, and time kernel, plain
   version and library yardstick; ``scatter_perm`` also at its tile edges
   and on both sides of its bin threshold (single pass up to 512 bins,
   three passes above), at 2^26 rows with all rows in one bin and with
   half in one bin, and over 10 launches that must be bit-equal;
3. the analytics main path at TPC-H SF 1 through ``lachesis_torch.Session``
   on the card: q04-, q17- and q02-like workloads over a round-robin store
   (device shuffles) and over a store partitioned on the join keys
   (elided), equal to the port's host backend;
4. write lineitem at SF 10 (60,000,000 rows) hash-partitioned, repartition
   it device to device, and hold both layouts to the host backend's bits;
5. flash attention against its plain version at the reference's test
   shapes, the bf16 kernel's edge cases, and internlm2-1.8b's prefill shape
   (float32 within 3e-5; bf16 within 2e-2 elementwise and 1e-2 relative
   RMS, with a control that drops one 64-key tile and must fail that
   check), timed;
6. the chunked SSD scan against its plain version at the reference's test
   shapes, one small shape under slow decay (Mamba-2's published init) and
   mamba2-370m's prefill shape under fast and slow decay (bf16, the
   tensor-core kernel, within 5e-2 elementwise and 1e-2 relative RMS, with
   a control that drops one tile pair under slow decay and must fail that
   check; float32, the CUDA-core kernel, within 1e-4), timed;
7. LM serving at full width: ``serve_batch`` for internlm2-1.8b (seeded
   random weights, batch 8, prompt 4096, 32 tokens) in bf16, timed, and in
   float32; finite logits; decode logits equal to a prefill's at two
   positions (within 5e-2 of the logits' max-abs in bf16, 1e-3 in
   float32); a profiler trace of one prefill and two decode steps;
8. the same for mamba2-370m;
9. the durable store and the history → advisor loop (Alg. 3) across
   restarts: q04-like runs over SF 1 logged into a history on the card and
   on the host (the advisor picks orderkey on both); SF-10 lineitem (phase
   4's arrays) and orders written under it into a durable store on the card
   and into a host twin, whose segments must be sha256-equal; a child
   process (this script with ``--phase9-child``) reopens the device store
   under a memory budget that holds one dataset, runs the q04-like consumer
   with both shuffles elided (equal to the host backend), spills and
   prefetches, logs q17-like runs until the advisor picks partkey and
   applies it device to device; the parent reopens generation 1 and holds
   it to the host twin's after the same repartition.  It runs in a
   temporary directory under ``build/`` that needs about 8 GB of free disk
   (checked first) and is removed at the end;
10. the Autopilot and the serving frontend on the card (``repro_torch.
   service``), over ``drift_tables`` at TPC-H SF 1 cardinalities (lineitem
   6,000,000 rows, orders 1,500,000, part 200,000; m = 32; SF 10 would
   make the host-numpy joins of eleven runs cost minutes): (a) the drift
   scenario's steps on a durable device store in a temporary directory
   under ``build/`` (batched persistence, flushed at the end; removed
   afterwards): 3 q_orderkey runs, a tick that moves lineitem and orders
   to orderkey d2d, a run with both join shuffles elided, 6 q_partkey runs
   with a tick in lineitem's cooldown after the second, a tick that moves
   lineitem to partkey d2d, a last run; every aggregate equal to the host
   backend's, every gate printed, each apply's wall not smaller than the
   CUDA-event time of its repartition, and a fresh Session on the root
   explaining the same why-records; (b) the skew actions over a Zipf
   lineitem at SF 0.25 (1,500,000 rows): a salt on an adaptive-capacity
   store and a rebucket (no row to the host) on a uniform one, each
   layout equal to a host twin's after the same actions; (c)
   ``Session.serve(max_workers=8, max_queue=64)`` with 16 clients of 4
   read-only lineitem aggregates (by partkey, elided, and by orderkey,
   re-bucketed on the card) while 4 d2d flips alternate lineitem's key:
   every result equal to the serial baseline, the generation up by 4, the
   hash kernels' launches exactly the flips' and the executions' device
   re-buckets; then ``ap.start``/``stop`` with no error;
11. the cluster tier (``repro_torch.cluster``) on the card across three
   processes (this script with ``--phase11-child``, started by phase 11
   itself), each traced under its own label: (write) TPC-H SF 10 lineitem
   and orders hash-partitioned on orderkey and part round-robin into a
   device cluster store of 4 node directories (replication 2, consistent
   hashing), the expected bits saved, q04-like (both shuffles elided) and
   q17-like (both re-bucketed) consumers held to exact row counts;
   (crash) a reopen and a rebalance onto a fifth node that dies after one
   dataset, before the epoch commit (``abort_after=1``), its trace spilled
   from ``on_abort``; (reopen) recovery to the old epoch bit-identical, a
   clean rebalance within the incremental bound, a node's directory
   deleted and every dataset served bit-identically from the survivors
   (columns on the card), one Autopilot tick that turns the lost node into
   an applied rebalance, a d2d repartition of lineitem on the cluster store
   (wall against CUDA events), an aggregate over part, and the three
   processes' traces merged and checked as the reference's cluster smoke
   checks them.  It runs in a temporary directory under ``build/`` whose
   free disk is checked first, and removes it;
12. training on the card: (a) the DRL selector — Fig. 12's run (A3C on
   the trace simulator over ``tpch_like_library()``, 80 epochs of 16
   transitions, reward before and after over 150 workloads, which must
   rise), the card agent against a CPU agent from the same weights
   (forward, one ``train_batch``), and ``DRLSelector`` of each over a
   q04-like history picking the same candidate; the two kernels'
   autograd Functions against their plain twins' VJP at one layer's
   shape; (b) mamba2-370m at full width and depth (bf16, remat),
   batch 8 × 2048: one loss/backward with every gradient leaf finite and
   nonzero (and those reaching the loss only through ``ssd_scan``), 10
   steps on one batch (the loss must fall; step seconds, tokens/s, peak
   memory, and the share of a step the kernels' backward takes, from
   torch.profiler), an int8-compressed step's wire bytes, and
   ``train_with_restarts`` (a failure at step 3 after a checkpoint at 2)
   against an uninterrupted run; (c) internlm2-1.8b, batch 4 × 2048, the
   gradient check (``wq``/``wk``/``wv`` only through ``flash_attention``)
   and 4 steps.  Launches and backward recomputes per step must equal a
   CPU dry run's (``tests/test_torch_train.py``).  Checkpoints go to a
   temporary directory under ``build/`` (free disk checked first),
   removed at the end;
13. mesh placement and the MoE and MLA layers: (a) phase 4's SF-10
   lineitem written again, repartitioned d2d onto a one-device ``Mesh`` on
   the card (``repartition(mesh=)``) and once more through
   ``apply_decision(mesh=)``: both layouts bit-equal to phase 4's host
   backend, every column on the card and placed as ``sharding_for`` says,
   the hash kernels launched as phase 4's write and two repartitions; the
   flash-attention kernel through MLA's padded route (q·k 128 + 64 and v
   128 in 256-wide buffers) at deepseek-v2's prefill shape in float32 and
   bf16, held to the plain twin on batch row 0's first 16 heads, timed
   beside SDPA on the padded tensors; then ``serve_batch`` (batch 8, prompt
   4096, 32 tokens, seeded random weights, full width, depth cut) for
   (b) deepseek-v2-236b with 3 layers (the dense MLA prefix layer and 2
   MoE layers; 9.33 B parameters) in bf16 and float32, (c)
   llama4-maverick-400b-a17b with 4 layers (one period: local/dense,
   local/MoE, local/dense, global NoPE/MoE; 35.04 B parameters, 70.1 GB,
   bf16 only: float32 would take 140 GB) and (d) chameleon-34b with 2
   layers in bf16: flash launched once per layer in the prefill, the MoE
   drop fractions at the configured capacity factor 1.25 printed, and
   decode logits against a prefill over the same tokens with a capacity
   factor of E / top_k, where nothing drops (batch 2 × 1024 for
   deepseek-v2, 2 × 512 for llama4, 8 × 4096 for chameleon; phase 7's
   limits);
14. the RG-LRU mixer, ring-buffered local caches, the encoder and
   cross-attention: (a) the flash kernel at recurrentgemma-9b's local
   layer (B=4, H=16 over one kv head, S=4096, hd=256, causal, window
   2048), whisper-small's encoder (B=8, H=12, 1500 frames, hd=64,
   non-causal) and its cross-attention (224 queries over 1500 frames), in
   float32 and bf16, held to the plain twin within phase 5's limits and
   timed beside the twin and SDPA (a boolean window mask for the first);
   (b) ``serve_batch`` for recurrentgemma-9b at full width and depth (38
   layers, 9,395,240,960 parameters, bf16; batch 4, prompt 4096 past the
   window, 32 tokens, seeded random weights): flash launched once per
   local layer (12), a traced prefill whose 12 ring caches must hold 2048
   slots, one layer's conv, gates and log-depth scan timed with CUDA
   events, and the bf16 decode-against-prefill gap at full depth printed
   (the state is rounded to bf16 every step, as in the reference);
   (c) decode against prefill at depth 5 (rglru, rglru, attn, rglru,
   rglru), float32 and bf16, batch 4: a prompt of 2040 and 16 steps (the
   ring wraps in decode) and a prompt of 4096 and 8 steps (it wrapped in
   the prefill), phase 7's limits; (d) whisper-small at full width and
   depth (12 encoder and 12 decoder layers), float32 and bf16:
   ``serve_batch`` at batch 8, prompt 224, 32 tokens over seeded random
   frames (8, 1500, 768), flash launched 36 times a prefill (12 encoder,
   12 decoder self-attention, 12 cross-attention), decode against prefill
   within phase 7's limits;
15. the SPMD layer, flash decode and the "dots" remat policy, for
   internlm2-1.8b in bf16 at full width and depth: (a) 32 decode steps
   over a 32,768-slot cache (batch 8, a prompt of 32,736) with flash
   decode off and then on (a fresh prefill, the first run's tokens fed),
   tokens/s of each and the two routes' logits within phase 7's bf16
   limit at its gated steps; (b) train steps (batch 4 × 2048) under
   ``remat_policy`` "full" and "dots" from one seeded state: step seconds,
   peak memory, the first loss equal, flash launches per step as phase
   12's; (c) the dry run on the fake 256-rank world (no card needed):
   internlm2-1.8b decode_32k, mamba2-370m train_4k and
   llama4-maverick-400b-a17b train_4k cut to 4 layers (6 all-to-alls over
   "model" per MoE layer and microbatch), and ``advise`` with its default
   scorer; (d) a one-rank NCCL world and a real (1, 1) ``DeviceMesh``:
   ``serve_batch`` at phase 7's shape with the parameters distributed by
   the sharding rules as DTensors, its greedy ids equal to phase 7's and
   24 flash launches in its prefill; the dry run of that prefill on a
   one-rank fake mesh beside the measured prefill seconds; and the
   kernels' custom ops against their bare launchers, host microseconds a
   call;
16. a stored dataset on a mesh of several positions: phase 4's SF-10
   lineitem written by orderkey, placed with ``device_put_dataset`` and
   repartitioned to partkey shard to shard (``repartition(mesh=)``: each
   shard hashes and orders its rows on its device, runs are copied to
   their destination blocks, each destination scatters its own) onto (a)
   ``Mesh([card] * 4, ("data",))``, (b) a (2, 2) ("data", "model") mesh
   over the card and (c) a mesh over the visible cards (the largest
   divisor of m not above their count; one card here); (d)
   ``apply_decision(mesh=)`` onto (a)'s mesh from a placed generation.
   Every shard bit-equal to the matching block of phase 4's host layout,
   no column read whole on one device, the hash kernels' launches equal
   to a CPU dry run's (``P16_LAUNCHES``); the wall after a synchronize,
   each step's CUDA-event time (source hash and order, copies, destination
   scatter) from a second, direct call, and the bytes that crossed shards
   from the histograms.  Then q04-like over SF-1 orders and lineitem, with
   lineitem placed on (a)'s mesh by ``apply_decision(mesh=)``, equal to
   the host backend's;
17. training the seven configs one card holds at full width, depth cut
   (``P17_LM``: whisper-small at full depth, recurrentgemma-9b 12 layers,
   gemma-7b 8, gemma2-27b 4, qwen1.5-110b 2, chameleon-34b 4,
   deepseek-v2-236b 2): (a) for each, one float32 ``value_and_grad`` at
   one pattern period of depth (B=1, S=128) through the float32 flash
   kernel and the twin's VJP, held to the CPU port's on the same weights
   and batch (loss within 1e-4 relative, every gradient leaf within 1e-3
   of its norm; ``wq`` and MLA's ``wq_b``/``wkv_b`` nonzero); (b) 4
   donated bf16 train steps at ``P17_LM``'s shape on one repeated batch,
   the bytes reckoned from the parameter shapes and printed before the
   call: a finite loss at every step, lower at the last, step seconds
   after a warm-up, tokens/s, peak memory, ``KernelAttention.backward``'s
   share of a traced step and MoE's ``dropped_frac``; then ``train`` (``TrainRun``) from a fresh
   state for 2 steps over ``TokenSource``'s batches, its final state
   checkpointed in the reference's stacked layout (under ``build/``,
   removed) where the checkpoint (weights and moments, and
   ``stack_state``'s copy of the stacked layers on the card) reckons
   above the step (deepseek-v2): finite losses, ``train``'s step seconds,
   the checkpoint's bytes as reckoned and its seconds, peak memory; the
   last config's ``train`` and (c) whisper-small's ``train_with_restarts``
   from a step-2 checkpoint (the reference's stacked layout, under
   ``build/``, removed), equal bit for bit to an uninterrupted run, run
   while (d) ``examples/torch/*.py`` run on the card, each in a process
   of its own, all started together: each must exit 0 (reddit_integration
   prints its wall and modelled speedups).  Flash launches and recomputes
   of (a) and per step of (b) must equal a CPU dry run's
   (``P17_LAUNCHES``);
18. the reduced configs on the card and the port's smoke scripts: (a)
   every config's reduced sibling (head dim 16, which the flash kernel
   runs zero-padded to 32) served at the CLI's shape (batch 4, prompt 64,
   32 tokens) through ``python -m repro_torch.launch.serve``'s ``main``
   and through ``serve_batch`` from weights made on the CPU, the greedy
   ids equal to the CPU port's on the same weights, each prefill's
   launches one per attention layer (SSD layer for mamba2), the flash
   launcher called at head dim 32 only; then reduced internlm2-1.8b
   trained 2 steps at the training CLI's batch (8 × 256), each step's
   loss and every gradient leaf held to the CPU port within phase 17
   (a)'s limits, 4 flash launches and 2 recomputes a step (a CPU dry
   run's, ``tests/test_torch_phase18.py``); all of (a) while (b)
   ``scripts/torch/{persistence_smoke,serving_stress,skew_smoke,
   cluster_smoke}.py`` run on the card at the CI job's arguments, each
   chain (write then reopen; write, crash, reopen) in order in a
   temporary directory under ``build/`` (removed), the four chains
   started together: every step must exit 0.

Launch counters are zeroed before each main path and read just after it:
phases 3-4 (hash-partition kernels; the scatter's route is printed and must
be the single pass), each of phase 7's serves (flash attention, 24
launches per prefill), each of phase 8's (SSD scan, 48), phase 9 (the
hash-partition kernels again, the child's launches added) and each part of
phase 10 (the hash-partition kernels, counted under a lock across the
frontend's threads), each process of phase 11 (the hash-partition
kernels, equal to the counts a CPU dry run of its steps predicts) and
phase 12's train steps (each LM's kernel and its backward recomputes,
per step equal to a CPU dry run's), phase 13 (a) (the hash-partition
kernels), each of phase 13's serves (flash attention, once per layer in
the prefill), each of phase 14's (flash attention: 12 per
recurrentgemma-9b prefill, 36 per whisper-small prefill) and each part of
phase 15 that runs the card (flash attention: 24 per prefill of (a), 48
per train step of (b), 24 in (d)'s prefill), and each repartition of
phase 16 (the hash-partition kernels, equal to the counts a CPU dry run
predicts), each call of phase 17 (a) and (b) (flash attention, equal
to a CPU dry run's ``P17_LAUNCHES``), and each serve and train step of
phase 18 (a) (flash attention and the SSD scan, one per layer a prefill;
``P18_TRAIN_LAUNCHES`` a step).
The second-to-last line is the kernel table as JSON, the last line the
device record.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12            # H100 SXM dense bf16 tensor cores
SOURCE = "src/repro_torch/kernels/hash_partition/csrc/hash_partition.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
REPLACES = {
    "hash_partition": "src/repro/kernels/hash_partition/hash_partition.py:83",
    "hash_partition_padded":
        "src/repro/kernels/hash_partition/hash_partition.py:142",
    "scatter_perm": "src/repro/kernels/hash_partition/hash_partition.py:208",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:94",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:73",
}
MAIN_N = 1 << 26                    # shape bucket of SF-10 lineitem
SF10_LINES = 60_000_000
SF10_ORDERS = 15_000_000
M = 32


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: no output"


# -- timing --------------------------------------------------------------------

def time_ms(torch, fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``reps`` launches, CUDA events, the 50 MB L2
    flushed before each one."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# -- phase 2: kernels against their plain versions -----------------------------

def check_kernels(torch, hp, ref, tdr, card):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def keys(n):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                             device=dev, generator=gen)

    def equal(a, b, what):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel differs from plain version")

    # edge shapes, key dtypes, stability
    for n in (0, 7, 2049):
        for m in (4, 32, 256):
            k = keys(n)
            p, c = hp.hash_partition(k, m)
            rp, rc = ref.hash_partition_ref(k, m)
            equal(p, rp, f"hash_partition n={n} m={m}")
            equal(c, rc, f"hash_partition counts n={n} m={m}")
            nv = n - n // 3
            pp, pc = hp.hash_partition_padded(k, nv, m)
            rpp, rpc = ref.hash_partition_padded_ref(k, nv, m)
            equal(pp, rpp, f"hash_partition_padded n={n} m={m}")
            equal(pc, rpc, f"hash_partition_padded counts n={n} m={m}")
            equal(hp.scatter_perm(pp, pc), ref.scatter_perm_ref(pp, pc),
                  f"scatter_perm n={n} m={m}")
    rng = torch.Generator(device="cpu").manual_seed(1)
    cases = {
        "int64 >= 2^31": torch.randint(2 ** 31, 2 ** 40, (4099,),
                                       generator=rng),
        "int64 negative": torch.randint(-2 ** 40, 0, (4099,), generator=rng),
        "float32": torch.randn(4099, generator=rng),
        "float64": torch.randn(4099, generator=rng,
                               dtype=torch.float64) * 1e6,
    }
    for name, host_keys in cases.items():
        k = tdr.as_kernel_keys(host_keys.to(dev))
        want = tdr.as_kernel_keys(host_keys)          # normalized on the CPU
        equal(k.cpu(), want, f"key normalization {name}")
        p, c = hp.hash_partition(k, 32)
        rp, rc = ref.hash_partition_ref(k, 32)
        equal(p, rp, f"hash_partition keys {name}")
        equal(c, rc, f"hash_partition counts keys {name}")
    pids = torch.tensor([2, 0, 2, 1, 0, 2, 0], dtype=torch.int32, device=dev)
    counts = torch.tensor([3, 1, 3], dtype=torch.int32, device=dev)
    dest = hp.scatter_perm(pids, counts).cpu().tolist()
    if dest != [4, 0, 5, 3, 1, 6, 2]:
        raise AssertionError(f"scatter_perm is not stable: {dest}")
    print("phase 2: edge shapes, key dtypes and the stable-order case "
          "bit-equal to the plain versions", flush=True)

    # the scatter's two routes at the tile edges, both sides of the bin
    # threshold
    T = hp.SCATTER_TILE_ROWS
    sgen = torch.Generator(device=dev).manual_seed(2)
    edge_bins = (33, 257, hp.SCATTER_SINGLE_PASS_MAX_BINS,
                 hp.SCATTER_SINGLE_PASS_MAX_BINS + 1)
    for bins in edge_bins:
        for n in (1, 31, T - 1, T, T + 1, 5 * T + 7):
            pids, counts = scatter_pids(torch, sgen, n, bins, "uniform")
            equal(hp.scatter_perm(pids, counts),
                  ref.scatter_perm_ref(pids, counts),
                  f"scatter_perm n={n} bins={bins} "
                  f"({hp.scatter_route(bins)})")
    print(f"phase 2: scatter_perm tile edges n = 1..5T+7 (T={T}) at bins "
          f"{edge_bins} ({[hp.scatter_route(b) for b in edge_bins]}) "
          "bit-equal to the plain version", flush=True)

    # main-path shapes, timed
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    k = keys(MAIN_N)
    results = {}
    for m in (M, 256):
        p, c = hp.hash_partition(k, m)
        rp, rc = ref.hash_partition_ref(k, m)
        equal(p, rp, f"hash_partition N=2^26 m={m}")
        equal(c, rc, f"hash_partition counts N=2^26 m={m}")
        pp, pc = hp.hash_partition_padded(k, SF10_LINES, m)
        rpp, rpc = ref.hash_partition_padded_ref(k, SF10_LINES, m)
        equal(pp, rpp, f"hash_partition_padded N=2^26 m={m}")
        equal(pc, rpc, f"hash_partition_padded counts N=2^26 m={m}")
        d = hp.scatter_perm(pp, pc)
        rd = ref.scatter_perm_ref(pp, pc)
        equal(d, rd, f"scatter_perm N=2^26 m={m}")
        check_scatter_main(torch, hp, ref, sgen, pp, pc, d, m, equal)
        errs = {
            "hash_partition": max(int((p - rp).abs().max()),
                                  int((c - rc).abs().max())),
            "hash_partition_padded": max(int((pp - rpp).abs().max()),
                                         int((pc - rpc).abs().max())),
            "scatter_perm": int((d - rd).abs().max()),
        }
        kern = {
            "hash_partition": lambda: hp.hash_partition(k, m),
            "hash_partition_padded":
                lambda: hp.hash_partition_padded(k, SF10_LINES, m),
            "scatter_perm": lambda: hp.scatter_perm(pp, pc),
        }
        plain = {
            "hash_partition": lambda: ref.hash_partition_ref(k, m),
            "hash_partition_padded":
                lambda: ref.hash_partition_padded_ref(k, SF10_LINES, m),
            "scatter_perm": lambda: ref.scatter_perm_ref(pp, pc),
        }
        # one PyTorch call computing the same function, where one exists:
        # the stable argsort is scatter_perm's permutation (inverted)
        library = {"scatter_perm": lambda: torch.argsort(pp, stable=True)}
        # each input read once, each output written once: 4 B of keys or
        # pids in, 4 B of pids or dests out per row, plus the histogram; the
        # padded form reads no key past n_valid (those rows get pid m)
        nbytes = {"hash_partition": 8 * MAIN_N + 4 * m,
                  "hash_partition_padded": 4 * SF10_LINES + 4 * MAIN_N
                  + 4 * (m + 1),
                  "scatter_perm": 8 * MAIN_N + 4 * (m + 1)}
        for name in kern:
            row = {
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": errs[name],
                "ms": time_ms(torch, kern[name], flush),
                "plain_ms": time_ms(torch, plain[name], flush, reps=5),
                "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": (time_ms(torch, library[name], flush)
                               if name in library else None),
            }
            print(f"phase 2: {name} N=2^26 m={m}: kernel_ms={row['ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']} "
                  f"max_abs_err={row['max_abs_err']} on {card}", flush=True)
            if m == M:
                results[name] = row
    del flush, k
    torch.cuda.empty_cache()
    return results


def scatter_pids(torch, gen, n, bins, case):
    """(pids, counts) of n rows over ``bins`` bins: uniform, all in one bin,
    or skewed (half the rows in one bin)."""
    dev = gen.device
    pids = torch.randint(0, bins, (n,), dtype=torch.int32, device=dev,
                         generator=gen)
    if case == "one_bin":
        pids.fill_(bins // 2)
    elif case == "skewed":
        pids[torch.rand(n, device=dev, generator=gen) < 0.5] = min(3, bins - 1)
    return pids, torch.bincount(pids, minlength=bins).to(torch.int32)


def check_scatter_main(torch, hp, ref, gen, pp, pc, d, m, equal):
    """scatter_perm at 2^26 rows beyond the padded SF-10 pids: all rows in
    one bin, half in one bin, both sides of the bin threshold, and ten
    launches on the padded pids bit-equal to the first."""
    bins = m + 1
    for case in ("one_bin", "skewed"):
        pids, counts = scatter_pids(torch, gen, MAIN_N, bins, case)
        equal(hp.scatter_perm(pids, counts),
              ref.scatter_perm_ref(pids, counts),
              f"scatter_perm N=2^26 bins={bins} {case}")
    sides = (hp.SCATTER_SINGLE_PASS_MAX_BINS,
             hp.SCATTER_SINGLE_PASS_MAX_BINS + 1)
    if m == M:
        for b in sides:
            pids, counts = scatter_pids(torch, gen, MAIN_N, b, "uniform")
            equal(hp.scatter_perm(pids, counts),
                  ref.scatter_perm_ref(pids, counts),
                  f"scatter_perm N=2^26 bins={b} ({hp.scatter_route(b)})")
    del pids, counts
    for i in range(10):
        equal(hp.scatter_perm(pp, pc), d,
              f"scatter_perm N=2^26 m={m}: launch {i + 1} of 10")
    print(f"phase 2: scatter_perm N=2^26 bins={bins} "
          f"({hp.scatter_route(bins)}): padded SF-10 pids ({SF10_LINES} "
          f"valid, {MAIN_N - SF10_LINES} in bin {m}), one bin and skewed "
          "bit-equal to the plain version"
          + (f"; bins {sides} ({[hp.scatter_route(b) for b in sides]}) too"
             if m == M else "")
          + "; 10 launches bit-equal", flush=True)


# -- phase 3: TPC-H SF 1 through the Session -----------------------------------

def tpch_tables(np, sf: float, seed: int = 0):
    """Columns and dtypes of the benchmark's synthetic TPC-H tables."""
    rng = np.random.default_rng(seed)
    n_orders = int(1_500_000 * sf)
    n_lines = int(6_000_000 * sf)
    n_parts = int(200_000 * sf)
    orders = {"orderkey": np.arange(n_orders, dtype=np.int64),
              "custkey": rng.integers(0, n_orders // 10, n_orders),
              "odate": rng.integers(0, 2556, n_orders).astype(np.int32)}
    lineitem = {"orderkey": rng.integers(0, n_orders, n_lines),
                "partkey": rng.integers(0, n_parts, n_lines),
                "qty": rng.integers(1, 50, n_lines).astype(np.float32),
                "price": rng.normal(100, 20, n_lines).astype(np.float32)}
    part = {"partkey": np.arange(n_parts, dtype=np.int64),
            "size": rng.integers(1, 50, n_parts).astype(np.int32)}
    return orders, lineitem, part


def tpch_queries(Workload):
    def q04():
        wl = Workload("q04-like")
        li, od = wl.scan("lineitem"), wl.scan("orders")
        j = wl.join(li, od, left_key=li["orderkey"],
                    right_key=od["orderkey"], tag="li_orders")
        wl.write(wl.aggregate(j, key=j["odate"], reducer="sum"), "q04_out")
        return wl

    def q17():
        wl = Workload("q17-like")
        li, pt = wl.scan("lineitem"), wl.scan("part")
        j = wl.join(li, pt, left_key=li["partkey"], right_key=pt["partkey"],
                    tag="li_part")
        wl.write(wl.aggregate(j, key=j["size"], reducer="mean"), "q17_out")
        return wl

    def q02():
        wl = Workload("q02-like")
        od, li = wl.scan("orders"), wl.scan("lineitem")
        j = wl.join(li, od, left_key=li["orderkey"],
                    right_key=od["orderkey"], tag="probe")
        f = wl.filter(j, j["qty"] > 40)
        wl.write(wl.aggregate(f, key=f["custkey"], reducer="sum"), "q02_out")
        return wl

    return {"q04": (q04, ("orders", "lineitem")),
            "q17": (q17, ("lineitem", "part")),
            "q02": (q02, ("orders", "lineitem"))}


def run_tpch(torch, np, lt, tcore, TableVal):
    """Returns the SF-1 tables (phase 9's history runs over them)."""
    orders, lineitem, part = tpch_tables(np, 1.0)
    tables = {"orders": orders, "lineitem": lineitem, "part": part}
    for qname, (build, keyed) in tpch_queries(lt.Workload).items():
        for layout in ("roundrobin", "partitioned"):
            res = {}
            for backend in ("device", "host"):
                sess = lt.Session(num_workers=M, backend=backend)
                wl = build()
                for tname, data in tables.items():
                    cand = None
                    if layout == "partitioned" and tname in keyed:
                        cand = tcore.enumerate_candidates(wl.graph, tname)[0]
                    sess.write(tname, data, cand)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = sess.run(wl)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                res[backend] = out
                print(f"phase 3: {qname} {layout} backend={backend}: "
                      f"wall_s={wall:.4f} shuffles={out.stats.shuffles_performed} "
                      f"elided={out.stats.shuffles_elided} "
                      f"shuffle_s={out.stats.shuffle_s:.4f}", flush=True)
            d, h = res["device"], res["host"]
            if (d.stats.shuffles_elided, d.stats.shuffles_performed) != \
                    (h.stats.shuffles_elided, h.stats.shuffles_performed):
                raise AssertionError(f"{qname} {layout}: verdicts differ")
            if layout == "roundrobin" and d.stats.device_repartitions == 0:
                raise AssertionError(f"{qname}: no device shuffle ran")
            if layout == "partitioned" and d.stats.shuffles_elided == 0:
                raise AssertionError(f"{qname}: nothing elided")
            rows = 0
            for nid, hv in h.values.items():
                if not isinstance(hv, TableVal):
                    continue
                dv = d.values[nid]
                if not np.array_equal(dv.counts, hv.counts):
                    raise AssertionError(f"{qname} node {nid}: counts differ")
                for k, col in hv.columns.items():
                    got = dv.columns[k]
                    if got.dtype != col.dtype or not np.array_equal(got, col):
                        raise AssertionError(
                            f"{qname} {layout} node {nid} column {k} differs")
                    if col.dtype.kind == "f" and not np.isfinite(col).all():
                        raise AssertionError(f"{qname}: non-finite {k}")
                rows = max(rows, hv.num_rows)
            print(f"phase 3: {qname} {layout}: device == host on every node "
                  f"(largest table {rows} rows)", flush=True)
    return orders, lineitem, part


# -- phase 4: SF 10 write and device-to-device repartition ---------------------

def same_layout(np, got, want, what):
    """Two ``export_layout``s equal bit for bit: counts, and every column's
    dtype, shape and bits."""
    if not np.array_equal(got["counts"], want["counts"]):
        raise AssertionError(f"{what}: counts differ from the host backend's")
    for k, col in want["columns"].items():
        g = got["columns"][k]
        if g.dtype != col.dtype or g.shape != col.shape \
                or not np.array_equal(g, col):
            raise AssertionError(f"{what}: column {k} differs from the host "
                                 "backend's")


def run_sf10(torch, np, lt, tcore, export_layout, hp):
    """Returns the SF-10 lineitem columns (phases 9 and 13 store them
    again), the host backend's repartitioned layout and the device
    backend's hash-kernel launches per step (phase 13 (a) holds its own to
    both)."""
    rng = np.random.default_rng(10)
    n_orders, n_parts = SF10_ORDERS, 2_000_000
    lineitem = {"orderkey": rng.integers(0, n_orders, SF10_LINES),
                "partkey": rng.integers(0, n_parts, SF10_LINES),
                "qty": rng.integers(1, 50, SF10_LINES).astype(np.float32),
                "price": rng.normal(100, 20, SF10_LINES).astype(np.float32)}
    flat_gb = sum(v.nbytes for v in lineitem.values()) / 1e9
    wl = lt.Workload("sf10")
    li = wl.scan("lineitem")
    wl.partition(li["orderkey"])
    wl.partition(li["partkey"])
    by_order, by_part = tcore.enumerate_candidates(wl.graph, "lineitem")
    layouts, steps = {}, {}
    for backend in ("device", "host"):
        sess = lt.Session(num_workers=M, backend=backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = Counter(hp.LAUNCHES)
        t0 = time.perf_counter()
        written = sess.write("lineitem", lineitem, by_order)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n1 = Counter(hp.LAUNCHES)
        moved_ds, moved = sess.repartition("lineitem", by_part)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if backend == "device":
            steps = {"write": n1 - n0, "repartition": Counter(hp.LAUNCHES) - n1}
        print(f"phase 4: backend={backend} {SF10_LINES} rows "
              f"({flat_gb:.2f} GB flat): write_s={t1 - t0:.4f} "
              f"repartition_s={t2 - t1:.4f} moved_bytes={moved} "
              f"path={sess.store.write_log[-1].get('path', 'host')} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()}",
              flush=True)
        layouts[backend] = (export_layout(written), export_layout(moved_ds))
        if backend == "device" and sess.store.write_log[-1]["path"] != "d2d":
            raise AssertionError("SF-10 repartition did not run d2d")
        del sess, written, moved_ds
        torch.cuda.empty_cache()
    for i, step in enumerate(("write", "repartition")):
        h = layouts["host"][i]
        same_layout(np, layouts["device"][i], h, f"SF-10 {step}")
        print(f"phase 4: SF-10 {step} layout bit-equal to the host backend "
              f"({int(h['counts'].sum())} rows)", flush=True)
    return lineitem, layouts["host"][1], steps


# -- phase 5: flash attention against its plain version ------------------------

# (B, H, KV, Sq, Skv, hd, causal, window, softcap, dtype): the reference's
# test shapes (tests/test_kernels.py), then the bf16 tensor-core kernel's
# window, softcap, kv tail, MQA, Sq != Skv, hd 32 and hd 256 cases
FLASH_CASES = [
    (1, 4, 2, 256, 256, 64, True, None, 0.0, "float32"),
    (2, 4, 4, 128, 128, 32, True, 64, 0.0, "float32"),
    (1, 2, 1, 192, 192, 64, False, None, 0.0, "float32"),   # MQA + kv tail
    (1, 4, 2, 256, 256, 64, True, None, 30.0, "float32"),   # softcap
    (1, 2, 2, 320, 320, 128, True, 128, 50.0, "float32"),
    (1, 4, 2, 256, 256, 64, True, None, 0.0, "bfloat16"),
    (1, 8, 2, 384, 384, 128, True, None, 0.0, "bfloat16"),  # GQA group 4
    (2, 4, 4, 128, 128, 32, True, 64, 0.0, "bfloat16"),     # window, hd 32
    (1, 4, 2, 256, 256, 64, True, None, 30.0, "bfloat16"),  # softcap
    (1, 2, 2, 320, 320, 128, True, 128, 50.0, "bfloat16"),  # + kv tail
    (1, 2, 2, 320, 320, 128, True, 80, 0.0, "bfloat16"),   # 32-row warps
    (1, 4, 2, 70, 200, 128, False, None, 0.0, "bfloat16"),  # + tails
    (1, 2, 1, 192, 192, 64, False, None, 0.0, "bfloat16"),  # MQA + kv tail
    (1, 2, 1, 70, 192, 64, False, None, 0.0, "bfloat16"),   # Sq != Skv
    (1, 2, 2, 192, 192, 256, True, None, 0.0, "bfloat16"),  # hd 256
    (1, 2, 2, 130, 130, 256, True, 100, 0.0, "bfloat16"),   # + window, tails
]
FA_MAIN = (8, 16, 8, 4096, 128)     # internlm2-1.8b prefill: B, H, KV, S, hd
TOL = {"float32": (3e-5, 1e-4), "bfloat16": (2e-2, 5e-2)}   # flash, SSD
# relative RMS error ||got - want|| / ||want|| of bf16 flash attention and
# SSD: bf16 rounding alone gives about 1e-3 (SSD 3e-3), a skipped 64-key
# tile about 1e-1
RMS_LIMIT = 1e-2
DROPPED_TILE = (2048, 2112)         # the control's missing keys at S=4096


def check_close(torch, got, want, tol, what) -> float:
    """The reference's allclose (atol = rtol = tol, elementwise); returns
    the max abs error."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    diff = (got - want).abs()
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {float(diff.max())} "
                             f"outside atol=rtol={tol}")
    return float(diff.max())


def rel_rms(torch, got, want) -> float:
    torch.cuda.synchronize()
    return float(torch.linalg.vector_norm((got.double() - want.double()))
                 / torch.linalg.vector_norm(want.double()))


def attention_dropping(torch, q, k, v, keys):
    """Causal plain attention with the keys in ``range(*keys)`` left out,
    one batch row at a time: the control that the relative-RMS check must
    reject."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & ~(
        (pos[None, :] >= keys[0]) & (pos[None, :] < keys[1]))
    out = []
    for b in range(B):
        s = torch.einsum("hqd,hkd->hqk", q[b].float() / math.sqrt(hd),
                         k[b].float().repeat_interleave(G, 0))
        p = torch.softmax(s.masked_fill_(~mask, -1e30), dim=-1)
        out.append(torch.einsum("hqk,hkd->hqd", p, v[b].float()
                                .repeat_interleave(G, 0)).to(q.dtype))
        del s, p
    return torch.stack(out)


def run_flash(torch, fa, fa_ref, card):
    from repro_torch.kernels.cost import flash_attention_cost
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def qkv(B, H, KV, S, hd, dtype):
        # (B, S, heads, hd) buffers seen as (B, heads, S, hd), as the model
        # hands its projections over
        return [torch.randn((B, S, n, hd), generator=gen, device=dev)
                .to(dtype).transpose(1, 2) for n in (H, KV, KV)]

    for case in FLASH_CASES:
        B, H, KV, Sq, Skv, hd, causal, window, cap, dname = case
        dtype = getattr(torch, dname)
        q = qkv(B, H, KV, Sq, hd, dtype)[0]
        _, k, v = qkv(B, H, KV, Skv, hd, dtype)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa_ref.attention_ref(q, k, v, **kw)
        err = check_close(torch, got, want, TOL[dname][0],
                          f"flash_attention {case}")
        rms = rel_rms(torch, got, want)
        if dname == "bfloat16" and not rms <= RMS_LIMIT:
            raise AssertionError(f"flash_attention {case}: relative RMS "
                                 f"error {rms} above {RMS_LIMIT}")
        print(f"phase 5: flash_attention {case}: max_abs_err={err:.3e} "
              f"rel_rms={rms:.3e}", flush=True)

    B, H, KV, S, hd = FA_MAIN
    # float32 at the main shape holds every kv tile of the long rows to the
    # reference's tight limit; bf16's limit is near the outputs' own size
    q, k, v = qkv(B, H, KV, S, hd, torch.float32)
    err32 = check_close(torch, fa.flash_attention(q, k, v, causal=True),
                        fa_ref.attention_ref(q, k, v, causal=True),
                        TOL["float32"][0],
                        "flash_attention internlm2 prefill shape float32")
    print(f"phase 5: flash_attention B={B} H={H} KV={KV} S={S} hd={hd} "
          f"float32 causal: max_abs_err={err32:.3e}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()
    q, k, v = qkv(B, H, KV, S, hd, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa_ref.attention_ref(q, k, v, causal=True)
    err = check_close(torch, got, want, TOL["bfloat16"][0],
                      "flash_attention internlm2 prefill shape")
    rms = rel_rms(torch, got, want)
    del got
    torch.cuda.empty_cache()
    control = rel_rms(torch, attention_dropping(torch, q, k, v, DROPPED_TILE),
                      want)
    print(f"phase 5: flash_attention B={B} H={H} KV={KV} S={S} hd={hd} bf16 "
          f"causal: rel_rms={rms:.3e} (limit {RMS_LIMIT}); control with keys "
          f"{DROPPED_TILE[0]}..{DROPPED_TILE[1] - 1} dropped: "
          f"rel_rms={control:.3e}", flush=True)
    if not rms <= RMS_LIMIT:
        raise AssertionError("flash_attention internlm2 prefill shape: "
                             f"relative RMS error {rms} above {RMS_LIMIT}")
    if control <= RMS_LIMIT:
        raise AssertionError("the relative-RMS check passes attention with "
                             "a 64-key tile dropped: it cannot catch one")
    del want
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    # every (q, k) pair with k <= q: 2 FLOPs a multiply-add, QK^T and PV
    flops, nbytes = flash_attention_cost(B, H, KV, S, S, hd, True, None,
                                         q.element_size())
    row = {
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": REPLACES["flash_attention"], "launches": 0,
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                      flush, reps=10),
        "plain_ms": time_ms(torch, lambda: fa_ref.attention_ref(
            q, k, v, causal=True), flush, reps=3, warmup=1),
        "bound_ms": max(flops / BF16_FLOP_PER_S,
                        nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                     > nbytes / HBM_BYTES_PER_S else "bytes"),
        "library_ms": time_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), flush, reps=10),
    }
    print(f"phase 5: flash_attention B={B} H={H} KV={KV} S={S} hd={hd} bf16 "
          f"causal: kernel_ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
          f"({row['bound_by']}: {flops:.4g} FLOP, {nbytes} B) "
          f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"kernel_TFLOP/s={flops / row['ms'] / 1e9:.2f} "
          f"max_abs_err={err:.3e} on {card}", flush=True)
    del q, k, v, flush
    torch.cuda.empty_cache()
    return row


# -- phase 6: chunked SSD scan against its plain version -----------------------

# (B, T, H, P, N, chunk, dtype): tests/test_kernels.py
SSD_CASES = [
    (2, 128, 4, 32, 64, 32, "float32"),
    (1, 256, 8, 64, 128, 64, "float32"),
    (1, 128, 2, 16, 32, 16, "bfloat16"),
]
# slow decay (Mamba-2's published init): every key tile of a chunk reaches
# its later rows, so a wrong or skipped tile pair shows; one small shape
# (32-row tiles) here, the main shape below
SSD_SLOW_CASES = [(1, 256, 2, 32, 64, 32, "bfloat16")]
SSD_MAIN = (8, 4096, 32, 64, 128, 256)   # mamba2-370m prefill: B, T, H, P, N, L
# the control's missing tile pair of 64 rows (output tile, key tile): rows
# 192-255 against keys 128-191 of every chunk
SSD_DROPPED = (3, 2)
SSD_ROUTE = "bf16: tensor cores (mma.sync); float32: CUDA cores"


def ssd_inputs(torch, gen, B, T, H, P, N, dtype, decay="fast"):
    """x, B and C as slices of one (B, T, H*P + 2N) buffer, as the model's
    convolution output hands them over; dt (B, T, H) and A (H,) float32.
    ``fast``: dt = softplus(randn), A = -exp(0.3 randn) (about -0.7 a
    step); ``slow``: dt log-uniform in [1e-3, 1e-1], A = -U(1, 16)."""
    dev = gen.device
    conv = torch.randn((B, T, H * P + 2 * N), generator=gen, device=dev)
    conv[..., :H * P] *= 0.5
    conv[..., H * P:] *= 0.3
    conv = conv.to(dtype)
    x = conv[..., :H * P].reshape(B, T, H, P)
    Bm = conv[..., H * P:H * P + N]
    Cm = conv[..., H * P + N:]
    if decay == "fast":
        dt = torch.nn.functional.softplus(
            torch.randn((B, T, H), generator=gen, device=dev))
        A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.3)
    else:
        dt = torch.exp(torch.empty((B, T, H), device=dev).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen))
        A = -torch.empty((H,), device=dev).uniform_(1.0, 16.0,
                                                    generator=gen)
    return x, dt, A, Bm, Cm


def ssd_dropping(torch, y_ref, x, dt, A, Bm, Cm, L, tile=SSD_DROPPED,
                 rows=64):
    """The plain SSD output with one tile pair's intra-chunk term left out
    of every chunk: the control that the relative-RMS check must reject."""
    B, T, H, P = x.shape
    i0, j0 = tile[0] * rows, tile[1] * rows
    y = y_ref.float().clone()
    for c0 in range(0, T, L):
        dA = dt[:, c0:c0 + L] * A                                 # (B,L,H)
        cs = torch.cumsum(dA, dim=1)
        ci = Cm[:, c0 + i0:c0 + i0 + rows].float()
        bj = Bm[:, c0 + j0:c0 + j0 + rows].float()
        decay = torch.exp(cs[:, i0:i0 + rows, None, :]
                          - cs[:, None, j0:j0 + rows, :])         # (B,i,j,H)
        w = (torch.einsum("bin,bjn->bij", ci, bj)[..., None] * decay
             * dt[:, None, c0 + j0:c0 + j0 + rows])
        y[:, c0 + i0:c0 + i0 + rows] -= torch.einsum(
            "bijh,bjhp->bihp", w, x[:, c0 + j0:c0 + j0 + rows].float())
    return y.to(y_ref.dtype)


def check_ssd(torch, ss, ss_ref, args, chunk, dname, what):
    """The reference's allclose on y and the state, and for bf16 relative
    RMS <= RMS_LIMIT on both; returns (max abs err, y's relative RMS,
    the plain y)."""
    y, st = ss.ssd_scan(*args, chunk)
    yr, str_ = ss_ref.ssd_ref(*args, chunk)
    tol = TOL[dname][1]
    err = max(check_close(torch, y, yr, tol, f"ssd y {what}"),
              check_close(torch, st, str_, tol, f"ssd state {what}"))
    rms = rel_rms(torch, y, yr)
    rms_st = rel_rms(torch, st, str_)
    if dname == "bfloat16" and not max(rms, rms_st) <= RMS_LIMIT:
        raise AssertionError(f"ssd {what}: relative RMS error {rms} (y), "
                             f"{rms_st} (state) above {RMS_LIMIT}")
    return err, rms, yr


def run_ssd(torch, ss, ss_ref, card):
    from repro_torch.kernels.cost import ssd_scan_cost
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    for decay, cases in (("fast", SSD_CASES), ("slow", SSD_SLOW_CASES)):
        for case in cases:
            B, T, H, P, N, chunk, dname = case
            args = ssd_inputs(torch, gen, B, T, H, P, N,
                              getattr(torch, dname), decay)
            err, rms, _ = check_ssd(torch, ss, ss_ref, args, chunk, dname,
                                    f"{case} {decay} decay")
            route = ("tensor cores" if dname == "bfloat16"
                     else "CUDA cores")
            print(f"phase 6: ssd_scan {case} {decay} decay ({route}): "
                  f"max_abs_err={err:.3e} rel_rms={rms:.3e}", flush=True)

    B, T, H, P, N, L = SSD_MAIN
    errs = {}
    # fast decay last: its inputs are the ones timed below
    for decay in ("slow", "fast"):
        args = ssd_inputs(torch, gen, B, T, H, P, N, torch.bfloat16, decay)
        err, rms, yr = check_ssd(torch, ss, ss_ref, args, L, "bfloat16",
                                 f"mamba2 prefill shape {decay} decay")
        errs[decay] = err
        line = (f"phase 6: ssd_scan B={B} T={T} H={H} P={P} N={N} "
                f"chunk={L} bf16 {decay} decay: max_abs_err={err:.3e} "
                f"rel_rms={rms:.3e} (limit {RMS_LIMIT})")
        if decay == "slow":
            control = rel_rms(torch, ssd_dropping(torch, yr, *args, L), yr)
            line += (f"; control with tile pair {SSD_DROPPED} (rows "
                     f"{SSD_DROPPED[0] * 64}..{SSD_DROPPED[0] * 64 + 63} x "
                     f"keys {SSD_DROPPED[1] * 64}..{SSD_DROPPED[1] * 64 + 63}"
                     f") dropped: rel_rms={control:.3e}")
        print(line, flush=True)
        if decay == "slow" and control <= RMS_LIMIT:
            raise AssertionError("the relative-RMS check passes SSD with a "
                                 "tile pair dropped: it cannot catch one")
        del yr
    torch.cuda.empty_cache()
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    nc = T // L
    # causal work: C B^T's lower triangle once per (batch row, chunk), shared
    # by the heads; per head: W.x over the triangle, C.state^T, the state
    # update; 2 FLOPs a multiply-add
    flops, nbytes = ssd_scan_cost(B, T, H, P, N, L, args[0].element_size(),
                                  args[1].element_size())
    # tile-granular work of 64-row tiles, C B^T per head: per (batch row,
    # head, chunk) the 10 tile pairs j <= i of S and W.x, C.state^T and the
    # state update
    nt = L // 64
    tile_flops = 2.0 * B * H * nc * (nt * (nt + 1) / 2 * 64 * 64 * (N + P)
                                     + 2 * L * P * N)
    row = {
        "name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
        "replaces": REPLACES["ssd_scan"], "launches": 0,
        "max_abs_err": max(errs.values()),
        "ms": time_ms(torch, lambda: ss.ssd_scan(*args, L), flush, reps=10),
        "plain_ms": time_ms(torch, lambda: ss_ref.ssd_ref(*args, L), flush,
                            reps=3, warmup=1),
        "bound_ms": max(flops / BF16_FLOP_PER_S,
                        nbytes / HBM_BYTES_PER_S) * 1e3,
        "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                     > nbytes / HBM_BYTES_PER_S else "bytes"),
        "library_ms": None,     # no single PyTorch call computes SSD
    }
    print(f"phase 6: ssd_scan B={B} T={T} H={H} P={P} N={N} chunk={L} bf16 "
          f"({SSD_ROUTE}): "
          f"kernel_ms={row['ms']:.4f} bound_ms={row['bound_ms']:.4f} "
          f"({row['bound_by']}: {flops:.4g} FLOP, {nbytes} B) "
          f"plain_ms={row['plain_ms']:.4f} library_ms=None "
          f"kernel_TFLOP/s={flops / row['ms'] / 1e9:.2f} (causal FLOPs) "
          f"tile_TFLOP/s={tile_flops / row['ms'] / 1e9:.2f} "
          f"({tile_flops:.4g} tile-granular FLOPs) "
          f"max_abs_err={row['max_abs_err']:.3e} on {card}", flush=True)
    del args, flush
    torch.cuda.empty_cache()
    return row


# -- phases 7-8: LM serving at full width ---------------------------------------

SERVE_BATCH, PROMPT_LEN, GEN = 8, 4096, 32
# decode step i consumed generated token i at position PROMPT_LEN + i: its
# logits are those of a prefill over the prompt and tokens 0..i.  In bf16
# the caches (mamba2's SSD state above all) are rounded at every step, so
# decode drifts from prefill as the steps go; float32 holds the path itself
# to a tight limit.  (positions checked, limit as a share of the logits'
# max-abs)
DECODE_CHECKS = {"bfloat16": ((0, 1), 5e-2), "float32": ((0, GEN - 1), 1e-3)}


def device_busy(torch, fn):
    """(result, device-busy ms, wall ms, {kernel: ms}) of ``fn`` traced with
    torch.profiler's CUDA activity alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages() if e.self_device_time_total > 0}
    return out, sum(by_name.values()), wall, by_name


def run_serve(torch, np, arch, phase, counters, T, serve, get_config):
    """``serve_batch`` at full width with seeded random weights, in bf16 (the
    timed run) and in float32; returns each run's launch counts and its
    generated ids."""
    import dataclasses
    dev = torch.device("cuda")
    device_busy(torch, lambda: torch.ones(1, device=dev) + 1)  # tracer start-up
    launches, generated = {}, {}
    for dtype, (positions, limit) in DECODE_CHECKS.items():
        cfg = dataclasses.replace(get_config(arch), param_dtype=dtype)
        t0 = time.perf_counter()
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), dtype=np.int32)
        torch.cuda.synchronize()
        print(f"phase {phase}: {arch} {dtype}: {cfg.param_count()} "
              f"parameters initialised in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        for reset, _ in counters:
            reset()
        out, stats = serve.serve_batch(cfg, params, prompts, GEN, device=dev)
        launches[dtype] = {}
        for _, table in counters:
            launches[dtype].update(table)
        peak = torch.cuda.max_memory_allocated()
        print(f"phase {phase}: {arch} {dtype} serve_batch "
              f"batch={SERVE_BATCH} prompt={PROMPT_LEN} gen={GEN}: "
              f"prefill_s={stats['prefill_s']:.4f} "
              f"decode_s={stats['decode_s']:.4f} "
              f"decode_tokens_per_s={stats['tokens_per_s']:.1f} "
              f"max_memory_allocated={peak} launches={launches[dtype]}",
              flush=True)
        if out.shape != (SERVE_BATCH, GEN) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise AssertionError(f"{arch}: bad generated ids {out.shape}")
        generated[dtype] = out
        # the decode path again over serve's tokens, prefill and steps 1-2
        # traced, keeping the logits of the steps checked below
        kept, traced, step_busy, step_wall = {}, Counter(), 0.0, 0.0
        with torch.inference_mode():
            toks = torch.from_numpy(prompts).to(dev)
            (_, cache), busy, wall, by_name = device_busy(
                torch, lambda: T.prefill(cfg, params, toks,
                                         cache_len=PROMPT_LEN + GEN))
            print(f"phase {phase}: {arch} {dtype} prefill of {PROMPT_LEN} "
                  f"tokens traced: device busy {busy:.1f} ms of {wall:.1f} "
                  "ms wall; top " + "; ".join(
                      f"{k[:60]} {v:.2f} ms"
                      for k, v in Counter(by_name).most_common(3)),
                  flush=True)
            for i in range(GEN):
                tok = torch.from_numpy(out[:, i:i + 1]).to(dev)

                def step():
                    return T.decode_step(cfg, params, cache, tok,
                                         PROMPT_LEN + i)
                if i in (1, 2):
                    (lg, cache), busy, wall, by_name = device_busy(torch, step)
                    step_busy, step_wall = step_busy + busy, step_wall + wall
                    traced.update(by_name)
                else:
                    lg, cache = step()
                if not bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()):
                    raise AssertionError(f"{arch}: non-finite logits at "
                                         f"decode step {i}")
                if i in positions or i == GEN - 1:
                    kept[i] = lg
        # where a decode step's time goes: device busy against wall
        print(f"phase {phase}: {arch} {dtype} 2 decode steps traced: device "
              f"busy {step_busy:.2f} ms of {step_wall:.1f} ms wall; serve's "
              f"decode {stats['decode_s'] / GEN * 1e3:.2f} ms a step; top "
              + "; ".join(f"{k[:60]} {v:.2f} ms"
                          for k, v in traced.most_common(3)), flush=True)
        del cache
        for i, got in sorted(kept.items()):
            toks = torch.from_numpy(
                np.concatenate([prompts, out[:, :i + 1]], 1)).to(dev)
            with torch.inference_mode():
                ref, _ = T.prefill(cfg, params, toks)
            # the padded vocabulary rows hold the -1e30 sentinel: compare
            # the real vocabulary
            got = got[:, :cfg.vocab_size].float()
            ref = ref[:, :cfg.vocab_size].float()
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            gated = i in positions
            print(f"phase {phase}: {arch} {dtype} decode step {i} vs prefill "
                  f"of {toks.shape[1]} tokens: max_abs_err={err:.4e} "
                  f"(logits max-abs {scale:.4e}; "
                  + (f"limit {limit} of it)" if gated else
                     "bf16 drift, not a check)"), flush=True)
            if gated and not (math.isfinite(err) and err <= limit * scale):
                raise AssertionError(f"{arch} {dtype}: decode step {i} "
                                     f"logits differ from prefill by {err}")
        del params, kept, stats
        torch.cuda.empty_cache()
    return launches, generated


# -- phase 9: the durable store and the history → advisor loop at SF 10 --------

# two stores (the device one and its host twin), each holding SF-10
# lineitem twice (generations 0 and 1) and orders once, plus slack
PHASE9_SLACK_BYTES = 1 << 30


def p9_loader(Workload):
    """The producer: parses raw lineitem and writes ``lineitem``."""
    wl = Workload("tpch-loader")
    raw = wl.scan("lineitem_raw")
    wl.write(wl.map(raw, fn=lambda x: x, tag="parse_tbl"), "lineitem")
    return wl


def p9_q04(Workload):
    """q04-like: lineitem ⋈ orders on orderkey, a selective filter."""
    wl = Workload("q04-like")
    li, od = wl.scan("lineitem"), wl.scan("orders")
    j = wl.join(li, od, left_key=li["orderkey"], right_key=od["orderkey"],
                tag="li_orders")
    wl.filter(j, j["qty"] > 45)
    return wl


def p9_q17(Workload):
    """q17-like: lineitem ⋈ part on partkey, a selective filter."""
    wl = Workload("q17-like")
    li, pt = wl.scan("lineitem"), wl.scan("part")
    j = wl.join(li, pt, left_key=li["partkey"], right_key=pt["partkey"],
                tag="li_part")
    wl.filter(j, j["size"] > 45)
    return wl


def p9_result(res, TableVal):
    """The workload's last set-valued node (the filter's output)."""
    nid = max(n for n, v in res.values.items() if isinstance(v, TableVal))
    return res.values[nid]


def p9_same_table(np, got, want, what):
    if not np.array_equal(got.counts, want.counts):
        raise AssertionError(f"{what}: counts differ from the host backend")
    if set(got.columns) != set(want.columns):
        raise AssertionError(f"{what}: columns differ from the host backend")
    for k, col in want.columns.items():
        if got.columns[k].dtype != col.dtype \
                or not np.array_equal(got.columns[k], col):
            raise AssertionError(f"{what}: column {k} differs from the host "
                                 "backend")


def p9_files(root):
    """{path under datasets/: absolute path} of every segment and manifest
    of the store at ``root``."""
    base = Path(root) / "datasets"
    return {str(f.relative_to(base)): f for f in sorted(base.rglob("*"))
            if f.is_file() and (f.suffix == ".seg"
                                or f.name.startswith("manifest-"))}


def p9_sha256(path):
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def p9_manifest(path):
    man = json.loads(Path(path).read_text())
    man.pop("created_at")
    for entry in man["generation_log"]:
        entry.pop("created_at")
    return man


def p9_compare_stores(a, b, prefixes=("",)):
    """Every segment of store ``a`` byte-equal to ``b``'s (sha256), every
    manifest equal apart from its timestamps, over the files whose path
    under ``datasets/`` starts with one of ``prefixes``.  Returns (files,
    segment bytes)."""
    fa, fb = ({k: v for k, v in p9_files(root).items()
               if k.startswith(tuple(prefixes))} for root in (a, b))
    if sorted(fa) != sorted(fb) or not fa:
        raise AssertionError(f"store files differ: {sorted(fa)} vs "
                             f"{sorted(fb)}")
    segs = [k for k in fa if k.endswith(".seg")]
    with ThreadPoolExecutor(8) as pool:
        da = list(pool.map(p9_sha256, [fa[k] for k in segs]))
        db = list(pool.map(p9_sha256, [fb[k] for k in segs]))
    for k, x, y in zip(segs, da, db):
        if x != y:
            raise AssertionError(f"segment {k}: device store differs from "
                                 "the host store")
    for k in fa:
        if not k.endswith(".seg") and p9_manifest(fa[k]) != p9_manifest(fb[k]):
            raise AssertionError(f"manifest {k} differs apart from times")
    return len(fa), sum(fa[k].stat().st_size for k in segs)


def p9_history(np, lt, tcore, HistoryStore, backend, path, tables):
    """The loader and q04-like runs over SF-1 tables, observed into a
    history; returns (history, the advisor's decision for lineitem)."""
    hist = HistoryStore(path)
    sess = lt.Session(num_workers=M, backend=backend, history=hist)
    sess.write("lineitem_raw", tables["lineitem"])
    sess.write("orders", tables["orders"])
    loader, q04 = p9_loader(lt.Workload), p9_q04(lt.Workload)
    for i in range(2):
        sess.run(loader, timestamp=10.0 * i)
        res = sess.run(q04, timestamp=10.0 * i + 5)
        if res.stats.shuffles_performed != 2:
            raise AssertionError(f"{backend}: the history's q04 runs over a "
                                 "round-robin store must shuffle both sides")
    return hist


def p9_child(cfg) -> int:
    """Phase 9's second process: reopen the device store, elide, spill,
    prefetch, log q17-like runs until the advisor picks partkey, and
    repartition device to device.  Prints one JSON line last."""
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    sys.path.insert(0, str(SRC))
    import numpy as np

    import lachesis_torch as lt
    import repro_torch.core as tcore
    from repro_torch.core.executor import TableVal
    from repro_torch.kernels.hash_partition import hash_partition as hp

    card = card_line()
    out = {"launches": {}}
    hist = tcore.HistoryStore(cfg["history"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = lt.Session(num_workers=M, store_path=cfg["a"], history=hist,
                      memory_budget_bytes=cfg["budget"])
    out["attach_s"] = time.perf_counter() - t0
    store = sess.store
    print(f"phase 9 (child): attach_s={out['attach_s']:.4f} "
          f"({sorted(store.datasets)}; page cache warm: written by the "
          f"parent just before) on {card}", flush=True)
    for name, sigs in cfg["sigsets"].items():
        ds = store.datasets[name]
        if ds.generation != 0 or list(ds.partitioner.signature_set()) != sigs:
            raise AssertionError(f"{name} reopened at gen {ds.generation} "
                                 f"under {ds.partitioner.signature_set()}")
        if not ds.spilled:
            raise AssertionError(f"{name} did not reopen as memmap views")

    # the q04-like consumer: both partition nodes elided, equal to the
    # host backend over the host store (run beside it in a thread: the
    # two are host numpy, and numpy lets go of the GIL)
    hp.reset_launches()
    host = lt.Session(backend="host", store_path=cfg["b"])
    with ThreadPoolExecutor(1) as pool:
        hrun = pool.submit(host.run, p9_q04(lt.Workload))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.run(p9_q04(lt.Workload), timestamp=100.0)
        out["q04_s"] = time.perf_counter() - t0
        hres = hrun.result()
    st = res.stats
    if (st.shuffles_elided, st.shuffles_performed, st.shuffle_bytes) != \
            (2, 0, 0):
        raise AssertionError(f"reopened q04: elided {st.shuffles_elided}, "
                             f"performed {st.shuffles_performed}, "
                             f"{st.shuffle_bytes} shuffle bytes")
    got = p9_result(res, TableVal)
    del res
    p9_same_table(np, got, p9_result(hres, TableVal), "reopened q04")
    rows = got.num_rows
    del hres, host, got
    print(f"phase 9 (child): q04-like over the reopened store: elided 2, "
          f"shuffles 0, shuffle_bytes 0, {rows} rows equal to the host "
          f"backend's (run beside it); wall_s={out['q04_s']:.4f} "
          f"rehydrations="
          f"{st.storage_rehydrations} on {card}", flush=True)

    # spill and prefetch under the budget (room for one dataset)
    io0 = store.io_snapshot()
    torch.cuda.synchronize()
    li = sess.read("lineitem")              # prefetch host→device
    io1 = store.io_snapshot()
    if store.is_spilled("lineitem") or any(
            not isinstance(v, torch.Tensor) or v.device.type != "cuda"
            for v in li.columns.values()):
        raise AssertionError("reading lineitem did not prefetch it to cuda")
    padded = li.padded_bytes
    kept = {k: v.clone() for k, v in li.columns.items()}
    prefetched = io1["bytes_read"] - io0["bytes_read"]
    out["prefetch_s"] = io1["read_s"] - io0["read_s"]
    print(f"phase 9 (child): first-read prefetch (H2D from the page cache) "
          f"{prefetched} B in {out['prefetch_s']:.4f} s "
          f"({prefetched / out['prefetch_s'] / 1e9:.2f} GB/s) on {card}",
          flush=True)
    marks = {}

    def mark(key):
        def fn():
            if key not in marks:
                torch.cuda.synchronize()
                marks[key] = (time.perf_counter(),
                              torch.cuda.memory_allocated())
        return fn
    store.set_sync_point("spill:column", mark("start"))
    store.set_sync_point("spill:post_swap", mark("end"))
    sess.read("orders")                     # prefetch orders, spill lineitem
    store.set_sync_point("spill:column", None)
    store.set_sync_point("spill:post_swap", None)
    if not store.is_spilled("lineitem") or "end" not in marks:
        raise AssertionError("reading orders did not spill lineitem")
    freed = marks["start"][1] - marks["end"][1]
    out["spill_s"] = marks["end"][0] - marks["start"][0]
    out["spill_freed_bytes"] = freed
    if freed < padded:
        raise AssertionError(f"spilling lineitem freed {freed} B of device "
                             f"memory, less than its {padded} padded bytes")
    print(f"phase 9 (child): reading orders spilled lineitem: "
          f"spill_s={out['spill_s']:.4f}, memory_allocated dropped by "
          f"{freed} B (lineitem padded {padded} B) on {card}", flush=True)
    li = sess.read("lineitem")
    for k, v in li.columns.items():
        if v.device.type != "cuda" or not torch.equal(v, kept[k]):
            raise AssertionError(f"lineitem column {k} changed across a "
                                 "spill and a prefetch")
    del kept
    print("phase 9 (child): lineitem prefetched to cuda again, bit-equal",
          flush=True)

    # the history moves: q17-like runs until the advisor picks partkey
    _orders, lineitem1, part1 = tpch_tables(np, 1.0)
    s17 = lt.Session(num_workers=M, history=hist)
    s17.write("lineitem", lineitem1)
    s17.write("part", part1)
    q17, loader = p9_q17(lt.Workload), p9_loader(lt.Workload)
    want = tcore.enumerate_candidates(q17.graph, "lineitem")[0].signature()
    t = 110.0
    for n_q17 in range(1, 13):
        s17.run(q17, timestamp=t)
        dec = tcore.partitioning_creation(loader, "lineitem", hist,
                                          dataset_bytes=cfg["dataset_bytes"],
                                          now=t + 1)
        t += 10.0
        if dec.candidate.signature() == want:
            break
    else:
        raise AssertionError("12 q17-like runs and the advisor still keeps "
                             f"{dec.candidate.signature()}")
    out["q17_runs"] = n_q17
    out["decision"] = dec.candidate.signature()
    print(f"phase 9 (child): after {n_q17} q17-like runs the advisor picks "
          f"{dec.candidate.signature()} (history of "
          f"{len(hist.records)} records)", flush=True)
    del s17

    # apply: d2d repartition of the reopened SF-10 lineitem, persisted
    launched = dict(hp.LAUNCHES)
    hp.reset_launches()
    io0 = store.io_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, moved = tcore.apply_decision(store, dec)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    io1 = store.io_snapshot()
    d2d = dict(hp.LAUNCHES)
    if store.write_log[-1]["path"] != "d2d" or d2d["hash_partition"] == 0 \
            or d2d["scatter_perm"] == 0:
        raise AssertionError(f"apply_decision did not run d2d through the "
                             f"kernels: {store.write_log[-1].get('path')}, "
                             f"{d2d}")
    if store.generation_of("lineitem") != 1 or \
            store.durable.load_manifest("lineitem").generation != 1:
        raise AssertionError("generation 1 of lineitem was not persisted")
    out["persist_s"] = io1["write_s"] - io0["write_s"]
    out["repartition_s"] = apply_s - out["persist_s"]
    print(f"phase 9 (child): apply_decision d2d: {new.num_rows} rows, "
          f"moved_bytes={moved}, repartition_s={out['repartition_s']:.4f} "
          f"+ persist_s={out['persist_s']:.4f} "
          f"({io1['bytes_written'] - io0['bytes_written']} B) "
          f"launches {d2d} on {card}", flush=True)
    out["launches"] = {k: launched[k] + d2d[k] for k in launched}

    profiles = sess.telemetry()
    if [(p.workload, p.shuffles_elided, p.shuffles_performed)
            for p in profiles] != [("q04-like", 2, 0)]:
        raise AssertionError(f"telemetry: {profiles}")
    out["profiles"] = len(profiles)
    print(json.dumps({"child": out}), flush=True)
    return 0


def run_durable(torch, np, lt, tcore, lineitem, tpch1):
    """Phase 9 in the parent: history → advisor → durable SF-10 write on
    the card and on the host; the child process; the reopen."""
    import shutil
    import tempfile
    from repro_torch.core import HistoryStore

    card = card_line()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    li_bytes = sum(v.nbytes for v in lineitem.values())
    need = 2 * (2 * li_bytes + 20 * SF10_ORDERS) * 33 // 32 \
        + PHASE9_SLACK_BYTES
    free = shutil.disk_usage(build).free
    if free < need:
        raise AssertionError(f"phase 9 needs {need} B of free disk under "
                             f"{build}, and {free} B are free")
    tmp = Path(tempfile.mkdtemp(prefix="phase9-", dir=build))
    try:
        return _run_durable(torch, np, lt, tcore, HistoryStore, lineitem,
                            tpch1, tmp, card, li_bytes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_durable(torch, np, lt, tcore, HistoryStore, lineitem, tpch1, tmp,
                 card, li_bytes):
    orders1, lineitem1, _part1 = tpch1
    tables = {"lineitem": lineitem1, "orders": orders1}
    t0 = time.perf_counter()
    hists = {b: p9_history(np, lt, tcore, HistoryStore, b,
                           str(tmp / f"history-{b}.jsonl"), tables)
             for b in ("device", "host")}
    loader, q04 = p9_loader(lt.Workload), p9_q04(lt.Workload)
    decs = {b: tcore.partitioning_creation(loader, "lineitem", h,
                                           dataset_bytes=li_bytes, now=20.0)
            for b, h in hists.items()}
    want = tcore.enumerate_candidates(q04.graph, "lineitem")[0]
    d, h = decs["device"], decs["host"]
    if d.candidate.signature() != want.signature() \
            or (h.candidate.signature(), h.action_index) != \
            (d.candidate.signature(), d.action_index):
        raise AssertionError(f"advisor: device {d.candidate.signature()}, "
                             f"host {h.candidate.signature()}, want "
                             f"{want.signature()}")
    if [r.candidate_stats for r in hists["device"].records] != \
            [r.candidate_stats for r in hists["host"].records]:
        raise AssertionError("history candidate_stats differ between the "
                             "device and host backends")
    print(f"phase 9: history of {len(hists['device'].records)} runs (loader "
          f"+ q04-like over SF 1): the advisor picks "
          f"{d.candidate.signature()} on both backends, candidate_stats "
          f"equal ({time.perf_counter() - t0:.1f} s)", flush=True)

    rng = np.random.default_rng(19)
    orders = {"orderkey": np.arange(SF10_ORDERS, dtype=np.int64),
              "custkey": rng.integers(0, SF10_ORDERS // 10, SF10_ORDERS),
              "odate": rng.integers(0, 2556, SF10_ORDERS).astype(np.int32)}
    by_order = tcore.enumerate_candidates(q04.graph, "orders")[0]
    cands = {"lineitem": d.candidate, "orders": by_order}
    data = {"lineitem": lineitem, "orders": orders}
    roots = {"device": str(tmp / "A"), "host": str(tmp / "B")}
    padded = {}
    for backend, root in roots.items():
        sess = lt.Session(num_workers=M, backend=backend, store_path=root)
        for name in ("lineitem", "orders"):
            io0 = sess.store.io_snapshot()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ds = sess.write(name, data[name], cands[name])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            io1 = sess.store.io_snapshot()
            nb = io1["bytes_written"] - io0["bytes_written"]
            ws = io1["write_s"] - io0["write_s"]
            padded[name] = ds.padded_bytes
            print(f"phase 9: {backend} columns: {name} write_s={wall:.4f}, "
                  f"of which flush {nb} B in {ws:.4f} s "
                  f"({nb / ws / 1e9:.2f} GB/s"
                  f"{', D2H copy included' if backend == 'device' else ''})"
                  f" on {card}", flush=True)
        del sess, ds
    torch.cuda.empty_cache()
    files, nbytes = p9_compare_stores(roots["device"], roots["host"])
    print(f"phase 9: device store == host store: {files} files, {nbytes} B "
          "of segments sha256-equal, manifests equal apart from times",
          flush=True)
    hist_path = str(tmp / "history-device.jsonl")

    cfg = {"a": roots["device"], "b": roots["host"], "history": hist_path,
           "budget": padded["lineitem"] + padded["orders"] // 2,
           "dataset_bytes": li_bytes,
           "sigsets": {n: list(c.signature_set()) for n, c in cands.items()}}
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--phase9-child", json.dumps(cfg)],
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith('{"child"'):
            print(line, flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"phase 9 child exited {proc.returncode}")
    child = json.loads(next(x for x in lines if x.startswith('{"child"'))
                       )["child"]
    print(f"phase 9: child process done in {time.perf_counter() - t1:.1f} s",
          flush=True)

    # the parent reopens: generation 1 under partkey, the child's profiles
    q17 = p9_q17(lt.Workload)
    by_part = tcore.enumerate_candidates(q17.graph, "lineitem")[0]
    again = lt.Session(store_path=roots["device"])
    li = again.store.datasets["lineitem"]
    if li.generation != 1 or li.partitioner.signature_set() != \
            by_part.signature_set() or child["decision"] != \
            by_part.signature():
        raise AssertionError(f"reopened lineitem at gen {li.generation} "
                             f"under {li.partitioner.signature_set()}")
    if len(again.telemetry()) != child["profiles"]:
        raise AssertionError("the child's telemetry did not survive")
    host = lt.Session(backend="host", store_path=roots["host"])
    t1 = time.perf_counter()
    host.repartition("lineitem", by_part)
    host_s = time.perf_counter() - t1
    files, nbytes = p9_compare_stores(
        roots["device"], roots["host"],
        ("lineitem/gen-000001/", "lineitem/manifest-000001.json"))
    print(f"phase 9: reopened in the parent: lineitem at generation 1 under "
          f"partkey, {child['profiles']} run profile(s) kept; generation 1 "
          f"sha256-equal to the host store's after the same repartition "
          f"({files} files, {nbytes} B; host repartition+persist "
          f"{host_s:.4f} s)", flush=True)
    return child["launches"]


# -- phase 10: the Autopilot and the serving frontend on the card --------------

# drift_tables at TPC-H SF 1 cardinalities; the skew actions' zipf lineitem
# at SF 0.25 (SF 1 would make their host-numpy runs dominate the phase)
P10_SF1 = (6_000_000, 1_500_000, 200_000)
P10_SKEW = (1_500_000, 375_000, 50_000)
P10_FLIPS = 4


def p10_same(np, got, want, what):
    if set(got) != set(want):
        raise AssertionError(f"{what}: columns {sorted(got)} != "
                             f"{sorted(want)}")
    for k, w in want.items():
        g = got[k]
        g = g.cpu().numpy() if hasattr(g, "cpu") else np.asarray(g)
        w = w.cpu().numpy() if hasattr(w, "cpu") else np.asarray(w)
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{what}: column {k} differs")


def p10_same_layout(np, dev, host, what):
    p10_same(np, dev.columns, host.columns, what)
    if not np.array_equal(dev.counts, host.counts):
        raise AssertionError(f"{what}: counts differ")
    dc, hc = dev.capacity_map, host.capacity_map
    if (dc is None) != (hc is None) or (dc is not None and not (
            np.array_equal(dc.capacities, hc.capacities)
            and np.array_equal(dc.offsets, hc.offsets))):
        raise AssertionError(f"{what}: capacity maps differ")
    if dev.partitioner.signature() != host.partitioner.signature():
        raise AssertionError(f"{what}: partitioners differ")


def p10_event_timer(torch, store):
    """Wrap ``store.repartition`` in CUDA events; returns the list the
    (start, end) pairs land in, one per call."""
    events, orig = [], store.repartition

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        events.append((start, end))
        return out
    store.repartition = timed
    return events


def p10_tick(torch, ap, events, label, card):
    """One tick: print every gate, then each apply's wall beside the
    CUDA-event time of its repartition (the wall must not be smaller)."""
    n0 = len(events)
    rep = ap.tick()
    torch.cuda.synchronize()
    for w in rep.why:
        sc = w["score"] or {}
        gates = " ".join(f"{g['gate']}={'pass' if g['passed'] else 'FAIL'}"
                         for g in w["gates"])
        print(f"phase 10: {label} gate {w['dataset']} {w['action']} "
              f"{w['candidate'] or '-'}: accepted={w['accepted']} "
              f"benefit_s={sc.get('benefit_s', 0.0):.6f} "
              f"padding_benefit_s={sc.get('padding_benefit_s', 0.0):.6f} "
              f"repartition_s={sc.get('repartition_s', 0.0):.6f} "
              f"io_s={sc.get('io_s', 0.0):.6f} "
              f"hysteresis={sc.get('hysteresis', 0.0)} "
              f"amortized={sc.get('amortized_benefit_s', 0.0):.6f} "
              f"gated_cost={sc.get('gated_cost_s', 0.0):.6f} {gates}",
              flush=True)
    timed = iter(events[n0:])
    for a in rep.applied:
        line = (f"phase 10: {label} applied {a.dataset} {a.kind} "
                f"path={a.path} generation={a.generation} "
                f"wall_s={a.repartition_wall_s:.6f}")
        if a.kind in ("repartition", "unsalt", "salt"):
            start, end = next(timed)
            ev_s = start.elapsed_time(end) / 1e3
            line += f" cuda_event_s={ev_s:.6f}"
            if a.repartition_wall_s < ev_s:
                raise AssertionError(f"{label}: {a.dataset} apply wall "
                                     f"{a.repartition_wall_s} s < its "
                                     f"CUDA-event time {ev_s} s")
        print(line + f" on {card}", flush=True)
    return rep


def p10_drift(torch, np, lt, svc, tmp, card):
    """(a) The drift scenario's steps on a durable device store; the host
    backend's results are the reference."""
    tables = svc.drift_tables(*P10_SF1, seed=0)
    host = lt.Session(num_workers=M, backend="host")
    for name, data in tables.items():
        host.write(name, data)
    want = {}
    for q in (svc.q_orderkey, svc.q_partkey):
        t0 = time.perf_counter()
        wl = q()
        want[wl.app_id] = svc.aggregate_result(host.run(wl).values, wl)
        print(f"phase 10: (a) host backend {wl.app_id}: "
              f"wall_s={time.perf_counter() - t0:.4f} (host numpy)",
              flush=True)
    # batched persistence: with autoflush every run would persist its few
    # hundred output bytes and the io calibration would price lineitem's
    # generation at fsync latency (PERF.md §7); flushed explicitly below
    sess = lt.Session(store_path=str(tmp / "store"), num_workers=M,
                      autoflush=False)
    for name, data in tables.items():
        sess.write(name, data)
    torch.cuda.synchronize()
    events = p10_event_timer(torch, sess.store)
    ap = sess.autopilot(clock=svc.LogicalClock(),
                        config=svc.default_drift_config())

    def run(q, what):
        """One observed run, held to the host backend's aggregate."""
        wl = q()
        t0 = time.perf_counter()
        res = sess.run(wl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        p10_same(np, svc.aggregate_result(res.values, wl), want[wl.app_id],
                 f"(a) {what}")
        st = res.stats
        print(f"phase 10: (a) {what}: wall_s={wall:.4f} "
              f"shuffles={st.shuffles_performed} elided={st.shuffles_elided} "
              f"shuffle_s={st.shuffle_s:.4f} == host backend on {card}",
              flush=True)
        return st

    def lineitem():
        ds = sess.read("lineitem")
        return ds.generation, ds.partitioner.signature()

    for i in range(3):
        run(svc.q_orderkey, f"q_orderkey {i}")
    rep_a = p10_tick(torch, ap, events, "(a) tick A", card)
    got = {a.dataset: a for a in rep_a.applied}
    if not {"lineitem", "orders"} <= set(got) or \
            {got[d].path for d in ("lineitem", "orders")} != {"d2d"}:
        raise AssertionError(f"(a) tick A applied "
                             f"{[(a.dataset, a.path) for a in rep_a.applied]}")
    if lineitem() != (1, "scan/attr:orderkey/partition[hash]"):
        raise AssertionError(f"(a) lineitem after tick A: {lineitem()}")
    st = run(svc.q_orderkey, "q_orderkey after tick A")
    if st.shuffles_elided != 2:
        raise AssertionError("(a) both join shuffles must be elided")
    for i in range(6):
        run(svc.q_partkey, f"q_partkey {i}")
        if i == 1:
            mid = p10_tick(torch, ap, events, "(a) tick B (cooldown)", card)
            if "lineitem" in {a.dataset for a in mid.applied}:
                raise AssertionError("(a) lineitem flipped in cooldown")
    rep_b = p10_tick(torch, ap, events, "(a) tick B", card)
    got = {a.dataset: a for a in rep_b.applied}
    if "lineitem" not in got or got["lineitem"].path != "d2d":
        raise AssertionError(f"(a) tick B applied "
                             f"{[(a.dataset, a.path) for a in rep_b.applied]}")
    if lineitem() != (2, "scan/attr:partkey/partition[hash]"):
        raise AssertionError(f"(a) lineitem after tick B: {lineitem()}")
    st = run(svc.q_partkey, "q_partkey after tick B")
    if st.shuffles_elided != 2:
        raise AssertionError("(a) both partkey join shuffles must be elided")
    t0 = time.perf_counter()
    published = sess.flush()
    print(f"phase 10: (a) flushed {published} generation(s) in "
          f"{time.perf_counter() - t0:.4f} s on {card}", flush=True)
    live = sess.explain_decisions(limit=1 << 30)
    fresh = lt.Session(store_path=str(tmp / "store"))
    if fresh.explain_decisions(limit=1 << 30) != live or not live:
        raise AssertionError("(a) a fresh Session explains other records")
    if fresh.read("lineitem").generation != 2:
        raise AssertionError("(a) the reopened lineitem is not generation 2")
    print(f"phase 10: (a) {len(live)} why-records, equal in a fresh Session "
          f"on the same root; lineitem generations 0 → 1 (orderkey, d2d) → "
          f"2 (partkey, d2d); every aggregate equal to the host backend's",
          flush=True)


def p10_skew(torch, np, lt, svc, tcore, card):
    """(b) Salt on an adaptive-capacity device store, rebucket on a uniform
    one (an adaptive store plans every layout's capacity map when it
    writes it, so its maps never differ from their plans), each layout
    held to a host twin put through the same actions."""
    from repro_torch.data.partition_store import StoredDataset
    tables = svc.drift_tables(*P10_SKEW, seed=1, skew=1.5)
    for label, adaptive, cfg_kw, want_kind in (
            ("salt", True, {}, "salt"),
            ("rebucket", False, dict(skew_actions=True,
                                     hot_key_fraction=2.0), "rebucket")):
        dev = lt.Session(num_workers=M, adaptive_capacity=adaptive)
        host = lt.Session(num_workers=M, backend="host",
                          adaptive_capacity=adaptive)
        for name, data in tables.items():
            dev.write(name, data)
            host.write(name, data)
        events = p10_event_timer(torch, dev.store)
        ap = dev.autopilot(clock=svc.LogicalClock(), config=svc.
                           AutopilotConfig(min_runs=2.0, hysteresis=0.5,
                                           cooldown_ticks=0, **cfg_kw))
        wl = svc.q_orderkey()
        ref = svc.aggregate_result(host.run(wl).values, wl)
        for _ in range(3):
            dev.run(wl)
        # tests/test_skew_adaptive.py's calibrations: a fast network and
        # slow storage, the skew actions' sweet spot
        ap.cost_model.observe_shuffle(1e9, 0.1)
        ap.cost_model.observe_io(1e6, 1.0)
        kinds = []
        gathers = []
        orig_gather = StoredDataset.gather
        for tick in range(4):
            if want_kind == "rebucket" and "repartition" in kinds:
                # the rebucket's tick: no valid row may reach the host
                StoredDataset.gather = lambda self: (
                    gathers.append(self.name), orig_gather(self))[1]
            try:
                rep = p10_tick(torch, ap, events, f"(b) {label} tick {tick}",
                               card)
            finally:
                StoredDataset.gather = orig_gather
            for a in rep.applied:
                kinds.append(a.kind)
                if a.kind in ("repartition", "salt", "unsalt"):
                    host.store.repartition(host.read(a.dataset),
                                           a.decision.candidate, swap=True)
                else:
                    host.store.rebucket(a.dataset)
                if a.dataset == "lineitem":
                    want_path = {"repartition": "d2d", "salt": "host",
                                 "rebucket": "rebucket"}[a.kind]
                    if a.path != want_path:
                        raise AssertionError(f"(b) {a.kind} took {a.path}")
                p10_same_layout(np, dev.read(a.dataset),
                                host.read(a.dataset),
                                f"(b) {label} {a.kind} {a.dataset}")
            if want_kind in kinds:
                break
        if want_kind not in kinds:
            raise AssertionError(f"(b) no {want_kind} in {kinds}")
        if gathers:
            raise AssertionError(f"(b) the rebucket gathered {gathers} to "
                                 "the host")
        ds = dev.read("lineitem")
        if not all(v.device.type == dev.device.type
                   for v in ds.columns.values()):
            raise AssertionError(f"(b) {label}: lineitem left the card")
        res = dev.run(wl)
        p10_same(np, svc.aggregate_result(res.values, wl), ref,
                 f"(b) {label} run")
        print(f"phase 10: (b) {label}: actions {kinds}; lineitem skew "
              f"{ds.skew():.3f}, padded {ds.padded_bytes} B, waste "
              f"{ds.padding_waste()} B, bucketed "
              f"{ds.capacity_map is not None}; every layout equal to the "
              f"host twin's, the aggregate to the host backend's; on {card}",
              flush=True)


def p10_serve(torch, np, lt, svc, tcore, hp, card):
    """(c) 16 clients through ``Session.serve`` while lineitem flips d2d
    underneath; then the Autopilot's background thread."""
    import threading
    from repro_torch.data.partition_store import PartitionStore
    tables = svc.drift_tables(*P10_SF1, seed=2)
    store = PartitionStore(num_workers=M, max_retired_generations=8)
    sess = lt.Session(store)

    def agg(key):
        wl = lt.Workload(f"lineitem-by-{key}")
        li = wl.scan("lineitem")
        wl.aggregate(li, key=li[key], reducer="sum")
        return wl

    cands = {k: tcore.enumerate_candidates(agg(k).graph, "lineitem")[0]
             for k in ("orderkey", "partkey")}
    sess.write("lineitem", tables["lineitem"], cands["partkey"])
    want = {k: svc.aggregate_result(sess.run(agg(k)).values, agg(k))
            for k in cands}
    torch.cuda.synchronize()
    hp.reset_launches()
    tickets, errors, flips = [], [], []
    front = sess.serve(max_workers=8, max_queue=64)
    go = threading.Event()

    def client(cid):
        try:
            go.wait(60)
            for j in range(4):
                key = ("partkey", "orderkey")[(cid + j) % 2]
                wl = agg(key)
                t = front.submit(wl, block=True, timeout=600)
                tickets.append(t)
                p10_same(np, svc.aggregate_result(t.result(600).values, wl),
                         want[key], f"(c) client {cid} {key}")
        except Exception as e:              # noqa: BLE001
            errors.append((cid, e))

    def flipper():
        try:
            go.wait(60)
            for i in range(P10_FLIPS):
                key = ("orderkey", "partkey")[i % 2]
                new, _ = store.repartition(store.read("lineitem"),
                                           cands[key], swap=True)
                flips.append((new.generation, store.write_log[-1]["path"]))
        except Exception as e:              # noqa: BLE001
            errors.append(("flipper", e))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(16)]
    threads.append(threading.Thread(target=flipper))
    for t in threads:
        t.start()
    gen0 = store.read("lineitem").generation
    t0 = time.perf_counter()
    go.set()
    for t in threads:
        t.join(timeout=900)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("(c) a client or the flipper hung")
    if errors:
        raise AssertionError(f"(c) {len(errors)} failures, first "
                             f"{errors[0]!r}")
    st = front.stats()
    launched = dict(hp.LAUNCHES)
    gen1 = store.read("lineitem").generation
    if gen1 - gen0 != P10_FLIPS or {p for _, p in flips} != {"d2d"}:
        raise AssertionError(f"(c) flips {flips}: generation {gen0} → "
                             f"{gen1}")
    runs = {id(t): t.result(0) for t in tickets}.values()
    rebuckets = sum(r.stats.device_repartitions for r in runs)
    expect = {"hash_partition": P10_FLIPS,
              "hash_partition_padded": rebuckets,
              "scatter_perm": P10_FLIPS + rebuckets}
    if launched != expect:
        raise AssertionError(f"(c) launches {launched}, expected {expect}")
    if st["completed"] + st["coalesced"] != 64 or st["failed"]:
        raise AssertionError(f"(c) frontend stats {st}")
    print(f"phase 10: (c) 16 clients x 4 requests under {P10_FLIPS} d2d "
          f"flips (generation {gen0} → {gen1}): every result equal to the "
          f"serial baseline; executions {st['completed']}, coalesced "
          f"{st['coalesced']} (rate {st['coalesced'] / st['submitted']:.4f}"
          f"), device re-buckets {rebuckets}; p50_ms={st['p50_ms']:.3f} "
          f"p99_ms={st['p99_ms']:.3f} throughput={64 / wall:.3f} req/s over "
          f"wall_s={wall:.4f}; launches {launched} exact; on {card}",
          flush=True)
    ap = sess.autopilot(config=svc.AutopilotConfig(hysteresis=0.5))
    for _ in range(2):
        front.run(agg("orderkey"), timeout=600)
    ap.start(period_s=0.2)
    try:
        deadline = time.time() + 60
        while not ap.optimizer.reports and time.time() < deadline:
            front.run(agg("orderkey"), coalesce=False, timeout=600)
    finally:
        ap.stop(timeout=120)
        front.close()
    if ap.optimizer.last_error is not None:
        raise AssertionError(f"(c) the background Autopilot failed: "
                             f"{ap.optimizer.last_error!r}")
    if not ap.optimizer.reports:
        raise AssertionError("(c) the background Autopilot never ticked")
    applied = [(a.dataset, a.kind, a.path)
               for r in ap.optimizer.reports for a in r.applied]
    print(f"phase 10: (c) ap.start/stop: {len(ap.optimizer.reports)} "
          f"tick(s), applied {applied}, last_error None; on {card}",
          flush=True)


def run_service(torch, np, lt, tcore, hp):
    """Phase 10; returns the hash kernels' launches over the phase."""
    import shutil
    import tempfile
    from repro_torch import service as svc

    card = card_line()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase10-", dir=build))
    launches = Counter()
    try:
        for part, fn in (("(a)", lambda: p10_drift(torch, np, lt, svc, tmp,
                                                   card)),
                         ("(b)", lambda: p10_skew(torch, np, lt, svc, tcore,
                                                  card)),
                         ("(c)", lambda: p10_serve(torch, np, lt, svc, tcore,
                                                   hp, card))):
            hp.reset_launches()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            launches.update(hp.LAUNCHES)
            print(f"phase 10: {part} done in {time.perf_counter() - t0:.1f} s"
                  f" on {card}; launches {dict(hp.LAUNCHES)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches)


# -- phase 11: the cluster tier across three processes -------------------------

P11_NODES = ("node-a", "node-b", "node-c", "node-d")
P11_NEW, P11_LOST = "node-e", "node-a"
P11_STEPS = ("write", "crash", "reopen")
P11_DATASETS = ("lineitem", "orders", "part")
P11_REPLICATION = 2
#: full replicated generations of the three datasets the store may hold
#: on disk at once (the current one and two retired; unchanged parts of a
#: rebalanced generation are hard links)
P11_GENERATIONS = 3
P11_SLACK_BYTES = 1 << 30
#: the hash kernels' exact launches in each step, predicted by a CPU dry
#: run of the same steps with the shuffles forced into the card's fused
#: mode (``tests/test_torch_phase11.py``): write — three dispatched writes
#: (two keyed), q04-like with both shuffles elided, q17-like with both
#: re-bucketed; crash — none (a rebalance moves bytes, not rows); reopen —
#: a d2d repartition of lineitem and one re-bucketed aggregate over part
P11_LAUNCHES = {
    "write": {"hash_partition": 2, "hash_partition_padded": 2,
              "scatter_perm": 5},
    "crash": {"hash_partition": 0, "hash_partition_padded": 0,
              "scatter_perm": 0},
    "reopen": {"hash_partition": 1, "hash_partition_padded": 1,
               "scatter_perm": 2},
}


def p11_env(torch, np, device, sf, card, reset, read):
    """What the phase-11 steps run with: the packages, the device, the
    scale factor, the card's line, and the launch counters' reset/read."""
    from types import SimpleNamespace

    import lachesis_torch as lt
    import repro_torch.core as tcore
    from repro_torch import obs
    from repro_torch import service as svc
    from repro_torch.core.executor import TableVal
    from repro_torch.data import device_repartition as tdr

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    return SimpleNamespace(torch=torch, np=np, lt=lt, tcore=tcore, obs=obs,
                           svc=svc, tdr=tdr, TableVal=TableVal,
                           device=device, sf=sf, card=card, sync=sync,
                           reset=reset, launches=read, attach_seen=0)


def p11_timed(env, fn):
    """(fn(), its host wall, read after a synchronize)."""
    env.sync()
    t0 = time.perf_counter()
    out = fn()
    env.sync()
    return out, time.perf_counter() - t0


def p11_with_timed(env, name, times, fn):
    """Run ``fn`` with the store module's ``name`` wrapped in CUDA events
    (their seconds appended to ``times``; None off the card)."""
    from repro_torch.data import partition_store as tps
    orig = getattr(tps, name)
    torch = env.torch

    def timed(*a, **kw):
        if env.device != "cuda":
            times.append(None)
            return orig(*a, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
        return out
    setattr(tps, name, timed)
    try:
        return fn()
    finally:
        setattr(tps, name, orig)


def p11_digests(env, store):
    """sha256 of every gathered column and of the counts, per dataset:
    the bits a reopen must reproduce."""
    import hashlib
    np = env.np
    out = {}
    for name in P11_DATASETS:
        ds = store.read(name)
        cols = ds.gather()
        cols["__counts__"] = np.asarray(ds.counts, np.int64)
        with ThreadPoolExecutor(len(cols)) as pool:
            digests = pool.map(
                lambda kv: (kv[0], str(kv[1].dtype), list(kv[1].shape),
                            hashlib.sha256(
                                np.ascontiguousarray(kv[1])).hexdigest()),
                sorted(cols.items()))
        out[name] = [list(d) for d in digests]
    return out


def p11_h2d_s(env) -> float:
    """Seconds the recorded ``cluster.attach`` spans (reassembled columns
    moved to the store's device) took since the last call."""
    spans = [s for s in env.obs.finished_spans() if s.name == "cluster.attach"
             and s.span_id > env.attach_seen]
    if spans:
        env.attach_seen = max(s.span_id for s in spans)
    return sum(s.dur_s for s in spans)


def p11_check_bits(env, store, expected, what):
    t0 = time.perf_counter()
    got = p11_digests(env, store)
    if got != expected:
        bad = [n for n in P11_DATASETS if got[n] != expected[n]]
        raise AssertionError(f"{what}: {bad} not bit-identical")
    return time.perf_counter() - t0


def p11_on_device(env, store, what):
    for name in P11_DATASETS:
        ds = store.read(name)
        if env.device == "cuda" and any(
                not isinstance(v, env.torch.Tensor)
                or v.device.type != "cuda" for v in ds.columns.values()):
            raise AssertionError(f"{what}: {name}'s reassembled columns are "
                                 "not CUDA tensors")


def p11_checksums(env, ds):
    """Order-independent exact checksums of a dataset's valid rows: row
    count and, per column, the int64 sum of its values (floats by their
    bit patterns)."""
    np = env.np
    out = {"rows": int(ds.num_rows)}
    for k, v in sorted(ds.gather().items()):
        if v.dtype.kind == "f":
            v = v.view(np.int32 if v.itemsize == 4 else np.int64)
        out[k] = int(v.astype(np.int64).sum())
    return out


def p11_write(env, cfg):
    """Step (a), the first process: a 4-node cluster store on the card
    (replication 2, consistent hashing), SF-10 lineitem and orders
    hash-partitioned on orderkey and part round-robin; the expected bits
    saved beside the store; q04-like (both shuffles elided) and q17-like
    (both re-bucketed) consumers held to exact row counts."""
    np, lt, obs = env.np, env.lt, env.obs
    from repro_torch.cluster import ClusterConfig
    env.reset()
    out = {}
    sess = lt.Session(store_path=cfg["root"], num_workers=M,
                      device=env.device,
                      cluster=ClusterConfig(nodes=P11_NODES,
                                            replication=P11_REPLICATION))
    tele = sess.telemetry_store
    with obs.span("cluster_smoke.write", "smoke"):
        tele.save_trace_context(obs.TRACER.context(), "write")
        orders, lineitem, part = tpch_tables(np, env.sf, seed=11)
        q04, q17 = p9_q04(lt.Workload), p9_q17(lt.Workload)
        cands = {"lineitem": env.tcore.enumerate_candidates(
                     q04.graph, "lineitem")[0],
                 "orders": env.tcore.enumerate_candidates(
                     q04.graph, "orders")[0],
                 "part": None}
        data = {"lineitem": lineitem, "orders": orders, "part": part}
        for name in P11_DATASETS:
            io0 = sess.store.io_snapshot()
            _, wall = p11_timed(env, lambda: sess.write(
                name, data[name], cands[name]))
            io1 = sess.store.io_snapshot()
            persist = [s for s in obs.finished_spans()
                       if s.name == "cluster.persist"
                       and s.args.get("dataset") == name][-1]
            nb = io1["bytes_written"] - io0["bytes_written"]
            out[f"write_{name}"] = {
                "wall_s": wall, "persist_s": persist.dur_s,
                "d2h_s": persist.args["d2h_s"], "bytes": nb}
            rows = len(next(iter(data[name].values())))
            print(f"phase 11 (write): {name} {rows} rows: "
                  f"write_s={wall:.4f}, of which persist "
                  f"{persist.dur_s:.4f} s ({nb} B over {len(P11_NODES)} "
                  f"nodes x {P11_REPLICATION} replicas), its D2H copy "
                  f"{persist.args['d2h_s']:.4f} s on {env.card}",
                  flush=True)
        for node in P11_NODES:
            if not Path(cfg["root"], "nodes", node).is_dir():
                raise AssertionError(f"{node} holds no parts")
        if sess.store.placement_epoch != 0:
            raise AssertionError("a fresh cluster store is not at epoch 0")
        t0 = time.perf_counter()
        expected = p11_digests(env, sess.store)
        Path(cfg["work"], "expected.json").write_text(json.dumps(expected))
        out["digest_s"] = time.perf_counter() - t0
        want = {"q04": (lineitem["qty"] > 45,
                        (2, 0)),
                "q17": (part["size"][lineitem["partkey"]] > 45, (0, 2))}
        del orders, lineitem, part, data
        for qname, wl in (("q04", q04), ("q17", q17)):
            res, wall = p11_timed(env, lambda: sess.run(wl))
            mask, verdicts = want[qname]
            got = p9_result(res, env.TableVal)
            st = res.stats
            if (st.shuffles_elided, st.shuffles_performed) != verdicts:
                raise AssertionError(f"{qname}: elided {st.shuffles_elided}"
                                     f", performed {st.shuffles_performed}")
            if got.num_rows != int(mask.sum()):
                raise AssertionError(f"{qname}: {got.num_rows} rows, want "
                                     f"{int(mask.sum())}")
            out[f"{qname}_s"] = wall
            print(f"phase 11 (write): {qname}-like over the cluster store: "
                  f"elided {st.shuffles_elided}, shuffled "
                  f"{st.shuffles_performed}, {got.num_rows} rows (exact); "
                  f"wall_s={wall:.4f} shuffle_s={st.shuffle_s:.4f} on "
                  f"{env.card}", flush=True)
            del res, got
    obs.spill_spans(tele.dir, "write")
    sess.export_node_metrics("write")
    out["launches"] = env.launches()
    return out


def p11_crash(env, cfg):
    """Step (b), the second process: reopen, rebalance onto a fifth node
    and die after the first dataset is republished, before the epoch
    commit (``abort_after=1``), spilling the trace from ``on_abort`` with
    the ``cluster.rebalance`` span open; the new node's half-written
    directory is torn away."""
    import shutil
    lt, obs = env.lt, env.obs
    from repro_torch.cluster import RebalanceAborted
    env.reset()
    out = {}
    sess, out["attach_s"] = p11_timed(env, lambda: lt.Session(
        store_path=cfg["root"], device=env.device))
    store = sess.store
    if not store.is_cluster or store.placement_epoch != 0:
        raise AssertionError("the reopen did not find the cluster store at "
                             "epoch 0")
    p11_on_device(env, store, "crash reopen")
    out["h2d_s"] = p11_h2d_s(env)
    print(f"phase 11 (crash): reopened (parts reassembled, columns to "
          f"{env.device}) in {out['attach_s']:.4f} s, of which the H2D "
          f"copies {out['h2d_s']:.4f} s on {env.card}", flush=True)
    tele = sess.telemetry_store
    with obs.TRACER.attach(tele.load_trace_context("write")):
        with obs.span("cluster_smoke.crash", "smoke"):
            tele.save_trace_context(obs.TRACER.context(), "crash")
            plan = sess.plan_rebalance(add_nodes=(P11_NEW,),
                                       reason="smoke-crash")
            if plan.partitions_moved <= 0:
                raise AssertionError("the scale-out plan moves nothing")

            def on_abort():
                obs.spill_spans(tele.dir, "crash")
                sess.export_node_metrics("crash")

            t0 = time.perf_counter()
            try:
                sess.rebalance(plan=plan, abort_after=1, on_abort=on_abort)
            except RebalanceAborted as e:
                out["crash_s"] = time.perf_counter() - t0
                print(f"phase 11 (crash): {e} after {out['crash_s']:.4f} s "
                      f"({plan.partitions_moved}/{M} partitions planned to "
                      f"move) on {env.card}", flush=True)
            else:
                raise AssertionError("abort_after=1 did not abort")
    if store.placement_epoch != 0:
        raise AssertionError("the aborted rebalance flipped the epoch")
    shutil.rmtree(Path(cfg["root"], "nodes", P11_NEW), ignore_errors=True)
    out["launches"] = env.launches()
    return out


def p11_check_trace(doc):
    """The reference's cluster-smoke check over the merged trace: spans
    from all three processes, paired flows with a cross-process arrow per
    boundary (each across two pids), and the crashed rebalance present as
    an ``incomplete`` span of the crash process."""
    other = doc["otherData"]
    procs = other["processes"]
    if set(procs) != set(P11_STEPS):
        raise AssertionError(f"merged trace has processes {sorted(procs)}")
    events = doc["traceEvents"]
    pids = {ev["pid"] for ev in events if ev["ph"] == "X"}
    if set(procs.values()) - pids:
        raise AssertionError("a process has no spans in the merged trace")
    starts = {ev["id"]: ev for ev in events if ev["ph"] == "s"}
    finishes = {ev["id"]: ev for ev in events if ev["ph"] == "f"}
    if set(starts) != set(finishes):
        raise AssertionError("flow starts and finishes do not pair up")
    if other["cross_process_flows"] < 2:
        raise AssertionError("fewer than 2 cross-process flows")
    for i, ev in starts.items():
        if ev["name"] == "xproc" and finishes[i]["pid"] == ev["pid"]:
            raise AssertionError("a cross-process flow stays on one pid")
    if not [ev for ev in events if ev["ph"] == "X"
            and ev["name"] == "cluster.rebalance"
            and ev["args"].get("incomplete")
            and ev["args"].get("process") == "crash"]:
        raise AssertionError("the crash's open cluster.rebalance is missing")


def p11_reopen(env, cfg):
    """Step (c), the third process: recover to epoch 0 bit-identically,
    complete the rebalance, delete a node's directory and serve every
    dataset from the survivors, let one Autopilot tick turn the lost node
    into an applied rebalance, repartition lineitem device to device on
    the cluster store, aggregate part, then merge the three processes'
    traces."""
    import shutil
    np, lt, obs, svc = env.np, env.lt, env.obs, env.svc
    env.reset()
    out = {}
    expected = json.loads(Path(cfg["work"], "expected.json").read_text())
    sess, out["attach_s"] = p11_timed(env, lambda: lt.Session(
        store_path=cfg["root"], device=env.device))
    p11_h2d_s(env)
    tele = sess.telemetry_store
    with obs.TRACER.attach(tele.load_trace_context("crash")):
        with obs.span("cluster_smoke.reopen", "smoke"):
            tele.save_trace_context(obs.TRACER.context(), "reopen")
            store = sess.store
            if store.placement_epoch != 0 or \
                    store.directory.nodes != P11_NODES:
                raise AssertionError(
                    f"recovered epoch {store.placement_epoch} over "
                    f"{store.directory.nodes}")
            p11_on_device(env, store, "recovery")
            check_s = p11_check_bits(env, store, expected, "recovery")
            print(f"phase 11 (reopen): recovered epoch 0 after the crash, "
                  f"every dataset bit-identical (attach "
                  f"{out['attach_s']:.4f} s, check {check_s:.4f} s) on "
                  f"{env.card}", flush=True)

            res, out["rebalance_s"] = p11_timed(env, lambda: sess.rebalance(
                add_nodes=(P11_NEW,), reason="smoke-retry"))
            total = sum(float(store.read(n).padded_bytes)
                        for n in P11_DATASETS)
            bound = res.partitions_moved / M * total
            if res.epoch != 1 or res.bytes_moved > bound + 1e-9:
                raise AssertionError(f"rebalance: epoch {res.epoch}, moved "
                                     f"{res.bytes_moved} B > {bound} B")
            out["rebalance"] = {"moved": res.partitions_moved,
                                "bytes_moved": res.bytes_moved,
                                "replica_bytes": res.replica_bytes,
                                "bytes_linked": res.bytes_linked,
                                "padded_bytes": total}
            print(f"phase 11 (reopen): rebalance onto {P11_NEW}: epoch 1, "
                  f"{res.partitions_moved}/{M} partitions, bytes_moved="
                  f"{res.bytes_moved} (bound {bound:.0f}), replica_bytes="
                  f"{res.replica_bytes}, bytes_linked={res.bytes_linked}, "
                  f"wall_s={out['rebalance_s']:.4f} on {env.card}",
                  flush=True)

            del sess, store, res
            shutil.rmtree(Path(cfg["root"], "nodes", P11_LOST))
            sess, out["replica_attach_s"] = p11_timed(
                env, lambda: lt.Session(store_path=cfg["root"],
                                        device=env.device))
            store = sess.store
            if store.placement_epoch != 1:
                raise AssertionError("the reopen lost the committed epoch")
            p11_on_device(env, store, "replica reads")
            read = store.io_snapshot()
            check_s = p11_check_bits(env, store, expected, "replica reads")
            out["replica_bytes_read"] = read["bytes_read"]
            out["replica_h2d_s"] = p11_h2d_s(env)
            print(f"phase 11 (reopen): {P11_LOST}'s directory deleted; "
                  f"every dataset served from the survivors, bit-identical:"
                  f" reopen {out['replica_attach_s']:.4f} s "
                  f"({read['bytes_read']} B of parts read; H2D "
                  f"{out['replica_h2d_s']:.4f} s), check {check_s:.4f} s on "
                  f"{env.card}", flush=True)

            ap = sess.autopilot(clock=svc.LogicalClock(),
                                config=svc.AutopilotConfig(cooldown_ticks=0))
            health = store.health
            for step in range(1, health.miss_threshold + 2):
                for node in P11_NODES[1:] + (P11_NEW,):
                    health.heartbeat(node, step)
                health.tick(step)
            if health.dead_nodes() != [P11_LOST]:
                raise AssertionError(f"dead nodes {health.dead_nodes()}")
            rep, tick_s = p11_timed(env, ap.tick)
            applied = [a for a in rep.applied if a.kind == "rebalance"]
            why = [w for w in rep.why if w["action"] == "rebalance:node_lost"]
            if len(applied) != 1 or not why or not why[0]["accepted"] or \
                    store.placement_epoch != 2 or \
                    P11_LOST in store.directory.nodes:
                raise AssertionError(f"the Autopilot did not rebalance the "
                                     f"lost node away: {rep.applied}")
            out["autopilot"] = {"tick_s": tick_s,
                                "wall_s": applied[0].repartition_wall_s,
                                "moved_bytes": applied[0].moved_bytes}
            gates = " ".join(f"{g['gate']}={'pass' if g['passed'] else 'FAIL'}"
                             for g in why[0]["gates"])
            print(f"phase 11 (reopen): Autopilot tick: node_lost "
                  f"{P11_LOST} → rebalance applied, epoch 2, moved_bytes="
                  f"{applied[0].moved_bytes}, wall_s="
                  f"{applied[0].repartition_wall_s:.4f} (tick "
                  f"{tick_s:.4f} s), io_s priced "
                  f"{why[0]['score']['io_s']:.6f}, {gates} on {env.card}",
                  flush=True)

            before = p11_checksums(env, store.read("lineitem"))
            by_part = env.tcore.enumerate_candidates(
                p9_q17(lt.Workload).graph, "lineitem")[0]
            shuffles = []
            (new, moved), wall = p11_timed(env, lambda: p11_with_timed(
                env, "device_repartition_dataset", shuffles,
                lambda: sess.repartition("lineitem", by_part)))
            ev = shuffles[0] if shuffles else None
            persist = [s for s in obs.finished_spans()
                       if s.name == "cluster.persist"
                       and s.args.get("dataset") == "lineitem"][-1]
            if store.write_log[-1]["path"] != "d2d" or len(shuffles) != 1:
                raise AssertionError("the cluster store's repartition did "
                                     "not run device to device")
            if ev is not None and wall < ev:
                raise AssertionError(f"repartition wall {wall} s < its CUDA-"
                                     f"event time {ev} s")
            keys = new.gather()["partkey"]
            _, counts = env.tdr.shuffle_pids(keys, M, mode="hostperm",
                                             device="cpu")
            if not np.array_equal(np.asarray(new.counts), counts) or \
                    p11_checksums(env, new) != before:
                raise AssertionError("the d2d repartition changed rows or "
                                     "misplaced them")
            out["repartition"] = {"wall_s": wall, "cuda_event_s": ev,
                                  "persist_s": persist.dur_s,
                                  "d2h_s": persist.args["d2h_s"],
                                  "moved": moved}
            print(f"phase 11 (reopen): d2d repartition of lineitem on "
                  f"partkey over the cluster store: {new.num_rows} rows, "
                  f"wall_s={wall:.4f}, of which the d2d shuffle's CUDA "
                  f"events {ev if ev is None else round(ev, 6)} s and the "
                  f"persist to {len(store.directory.nodes)} nodes "
                  f"{persist.dur_s:.4f} s (D2H {persist.args['d2h_s']:.4f}"
                  f" s); rows and per-partition counts checked on "
                  f"{env.card}", flush=True)
            del new, keys

            wl = lt.Workload("part-by-size")
            wl.aggregate(wl.partition(wl.scan("part")["size"]),
                         reducer="sum")
            part = store.read("part").gather()
            res = sess.run(wl)
            agg = res.values[max(res.values)]
            want = np.bincount(part["size"], weights=part["partkey"])
            got = np.zeros_like(want)
            got[agg.columns["key"]] = agg.columns["partkey"]
            if res.stats.device_repartitions != 1 or \
                    not np.array_equal(got, want):
                raise AssertionError("the part aggregate is wrong")
            profiles = sess.telemetry()
            if len(profiles) < 3 or not {"write", "reopen"} <= {
                    p.process for p in profiles}:
                raise AssertionError(f"telemetry across restarts: "
                                     f"{[p.process for p in profiles]}")
    obs.spill_spans(tele.dir, "reopen")
    sess.export_node_metrics("reopen")
    doc = obs.write_merged_trace(str(Path(cfg["work"], "cluster_trace.json")),
                                 tele.dir, metadata={"smoke": "cluster"})
    p11_check_trace(doc)
    merged = sess.cluster_metrics()
    if set(merged["nodes"]) != set(P11_STEPS):
        raise AssertionError(f"merged metrics nodes {merged['nodes']}")
    obs.parse_prometheus_text(sess.cluster_metrics_text())
    o = doc["otherData"]
    out["trace"] = {k: o[k] for k in ("spans", "incomplete", "flows",
                                      "cross_process_flows")}
    print(f"phase 11 (reopen): merged trace of {len(o['processes'])} "
          f"processes: {o['spans']} spans, {o['cross_process_flows']} "
          f"cross-process flows, {o['incomplete']} incomplete (the crash's "
          f"cluster.rebalance); {len(profiles)} run profiles across "
          f"restarts", flush=True)
    out["launches"] = env.launches()
    return out


P11_STEP_FNS = {"write": p11_write, "crash": p11_crash,
                "reopen": p11_reopen}


def p11_child(cfg) -> int:
    """One phase-11 process: ``chip_smoke.py --phase11-child CONFIG``."""
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels.hash_partition import hash_partition as hp
    obs.enable("full", process=cfg["step"])
    env = p11_env(torch, np, "cuda", cfg["sf"], card_line(),
                  hp.reset_launches, lambda: dict(hp.LAUNCHES))
    out = P11_STEP_FNS[cfg["step"]](env, cfg)
    print(json.dumps({"child": out}), flush=True)
    return 0


def p11_disk_bytes(root) -> int:
    """Bytes the store holds on disk, a hard-linked part counted once."""
    import os
    seen, total = set(), 0
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            if (st.st_dev, st.st_ino) not in seen:
                seen.add((st.st_dev, st.st_ino))
                total += st.st_size
    return total


def run_cluster():
    """Phase 11 in the parent: three processes over one cluster store in
    a temporary directory under ``build/``; returns the hash kernels'
    launches over the phase."""
    import shutil
    import tempfile

    card = card_line()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    rows = {"lineitem": 6_000_000 * 24, "orders": 1_500_000 * 20,
            "part": 200_000 * 12}
    need = int(sum(rows.values()) * 10 * P11_REPLICATION * P11_GENERATIONS
               * 33 // 32) + P11_SLACK_BYTES
    free = shutil.disk_usage(build).free
    if free < need:
        raise AssertionError(f"phase 11 needs {need} B of free disk under "
                             f"{build}, and {free} B are free")
    tmp = Path(tempfile.mkdtemp(prefix="phase11-", dir=build))
    launches = Counter()
    try:
        for step in P11_STEPS:
            cfg = {"step": step, "root": str(tmp / "store"),
                   "work": str(tmp), "sf": 10.0}
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                                   "--phase11-child", json.dumps(cfg)],
                                  capture_output=True, text=True,
                                  timeout=600)
            lines = proc.stdout.splitlines()
            for line in lines:
                if not line.startswith('{"child"'):
                    print(line, flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr, flush=True)
                raise AssertionError(f"phase 11 {step} process exited "
                                     f"{proc.returncode}")
            child = json.loads(next(x for x in lines
                                    if x.startswith('{"child"')))["child"]
            if child["launches"] != P11_LAUNCHES[step]:
                raise AssertionError(f"phase 11 {step}: launches "
                                     f"{child['launches']}, predicted "
                                     f"{P11_LAUNCHES[step]}")
            launches.update(child["launches"])
            print(f"phase 11: {step} process done in "
                  f"{time.perf_counter() - t0:.1f} s on {card}; launches "
                  f"{child['launches']} (as predicted); store on disk "
                  f"{p11_disk_bytes(tmp / 'store')} B", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(launches)


# -- phase 12: training on the card --------------------------------------------

#: Fig. 12's setup (``benchmarks/bench_drl_training.py``): epochs of
#: transitions, and workloads evaluated before and after
P12_EPOCHS, P12_BATCH, P12_EVAL = 80, 16, 150


def p12_evaluate(agent, sim, n):
    """Mean greedy reward and mean oracle reward over ``n`` sampled
    workloads (the benchmark's ``evaluate``)."""
    tot = opt = 0.0
    for _ in range(n):
        wl = sim.sample_workload()
        s, m = sim.state_of(wl)
        tot += sim.reward_of(wl, agent.select(s, m, greedy=True))
        opt += sim.reward_of(wl, sim.best_action(wl))
    return tot / n, opt / n


def p12_fig12(np, env, agent_mod, device, epochs=P12_EPOCHS,
              batch=P12_BATCH, n_eval=P12_EVAL, seed=0):
    """Fig. 12: an A3C agent on ``device`` trained on the trace simulator
    over ``tpch_like_library()``; the reward before and after, the
    oracle's, the losses and the seconds per epoch."""
    queries, cfg = env.tpch_like_library()
    sim = env.TraceSimulator(queries, cfg)
    agent = agent_mod.A3CAgent(agent_mod.A3CConfig(
        state_dim=sim.state_dim, num_actions=cfg.num_candidates, seed=seed),
        device=device)
    r0, ropt = p12_evaluate(agent, sim, n_eval)
    losses = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        rows = []
        for _ in range(batch):
            wl = sim.sample_workload()
            s, m = sim.state_of(wl)
            a = agent.select(s, m)
            rows.append(agent_mod.Transition(s, a, sim.reward_of(wl, a), m))
        losses.append(agent.train_batch(rows)[0])
    epoch_s = (time.perf_counter() - t0) / epochs
    r1, _ = p12_evaluate(agent, sim, n_eval)
    return {"reward_before": r0, "reward_after": r1, "oracle": ropt,
            "losses": losses, "epoch_s": epoch_s, "agent": agent}


#: phase 12 (b)-(c): (arch, batch, sequence, steps on one fixed batch);
#: full width and depth, bf16 as the configs say, remat on
P12_LM = (("mamba2-370m", 8, 2048, 10), ("internlm2-1.8b", 4, 2048, 4))
#: one train step's (one loss and backward) launches of the mixer's kernel
#: and backward recomputes through its plain twin, predicted by a CPU dry
#: run of the same steps at the same depth with the kernels' Functions on
#: CPU stand-ins (``tests/test_torch_train.py``): under remat each layer's
#: forward runs twice (the forward pass, the recompute before its
#: backward) and its backward once
P12_LAUNCHES = {"mamba2-370m": {"launches": 96, "recomputes": 48},
                "internlm2-1.8b": {"launches": 48, "recomputes": 24}}
#: the restart check: steps, checkpoint every, injected failure at (one
#: lost step replayed, to keep the script inside its time limit)
P12_RESTART = (4, 2, 3)
#: the largest difference between the restarted run and an uninterrupted
#: one, over the losses after the restore and every leaf of the final
#: state (parameters, moments, step): the restored state is bit-exact and
#: the batches the same, so they must agree bit for bit
P12_RESTART_TOL = 0.0
#: the kernel Functions' gradients against the plain twins' VJP: the
#: backward *is* that VJP at the same inputs, so this holds only the wiring
#: (saved inputs, cotangent dtypes); run-to-run reduction order apart, as a
#: share of the largest gradient entry
P12_VJP_TOL = 1e-5
#: the card agent against a CPU agent from the same weights: forward
#: (float32 GEMMs, TF32 off), then parameters after one train_batch
P12_AGENT_TOL = (1e-6, 1e-5)
P12_LR = 3e-4
#: disk beyond mamba2-370m's three checkpoints (bf16 params and moments)
P12_SLACK_BYTES = 1 << 30


def p12_env(torch, np, device, card):
    """What the phase-12 LM steps run with: the device, the card's line,
    and the kernels' counters (launches and backward recomputes)."""
    from types import SimpleNamespace

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    mods = {"flash_attention": fa, "ssd_scan": ss}

    def reset():
        fa.reset_launches()
        ss.reset_launches()

    def read(kernel):
        return {"launches": mods[kernel].LAUNCHES[kernel],
                "recomputes": mods[kernel].RECOMPUTES[kernel]}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    return SimpleNamespace(torch=torch, np=np, device=device, card=card,
                           reset=reset, read=read, sync=sync)


def p12_kernel_only(cfg, grads):
    """{name: smallest norm over the layers} of the gradient slices that
    reach the loss only through the mixer's kernel: SSD — ``A_log``,
    ``dt_bias``, the B, C and dt columns of ``in_proj`` and the B and C
    channels of the convolution (x also feeds the D skip); attention —
    ``wq``, ``wk``, ``wv``."""
    out = {}
    for layer in grads["layers"]:
        g = layer["attn"]
        if cfg.ssd is not None:
            di, n = cfg.ssd.d_inner, cfg.ssd.state
            parts = {"A_log": g["A_log"], "dt_bias": g["dt_bias"],
                     "in_proj[B,C]": g["in_proj"]["w"][:, 2 * di:2 * di + 2 * n],
                     "in_proj[dt]": g["in_proj"]["w"][:, 2 * di + 2 * n:],
                     "conv_w[B,C]": g["conv_w"][:, di:],
                     "conv_b[B,C]": g["conv_b"][di:]}
        else:
            parts = {k: g[k]["w"] for k in ("wq", "wk", "wv")}
        for k, t in parts.items():
            norm = float(t.float().norm())
            out[k] = min(out.get(k, norm), norm)
    return out


def p12_recompute_share(torch, step):
    """The share of one train step's device time spent in the kernels'
    backward (the plain twins' recompute and VJP), from torch.profiler:
    the device time under the autograd nodes ``KernelSSDBackward`` and
    ``KernelAttentionBackward`` over all device time.  (recompute ms, step
    device ms), or None where the trace shows no such node."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the kernels' own events; a CPU op's self device time repeats them
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    back = [e.device_time_total / 1e3 for e in events
            if "Kernel" in e.key and "Backward" in e.key
            and "evaluate_function" in e.key]
    return (max(back), total) if back and total > 0 else None


def p12_lm(env, cfg, arch, batch, seq, n_steps, work, restart=True,
           int8=True):
    """Phase 12 (b)/(c) for one LM: the gradient check, ``n_steps`` train
    steps on one fixed batch (the loss must fall), launches per step held
    to :data:`P12_LAUNCHES`, one int8-compressed step's wire bytes, and
    ``train_with_restarts`` against an uninterrupted run.  Returns the
    numbers it printed."""
    torch, np = env.torch, env.np
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import steps as S

    dev = env.device
    kernel = "ssd_scan" if cfg.ssd is not None else "flash_attention"
    want = P12_LAUNCHES[arch]
    out = {"arch": arch, "layers": cfg.num_layers}
    what = f"{arch} B={batch} S={seq} {cfg.param_dtype}"
    src = TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch))
    b0 = {k: torch.as_tensor(v, device=dev)
          for k, v in src.batch_at(0, 0).items()}
    opt = S.make_optimizer(cfg, peak_lr=P12_LR, total_steps=n_steps)
    state = S.init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                               opt, device=dev)

    # one loss and backward: every leaf's gradient finite and nonzero
    env.reset()
    loss, _, grads = S.value_and_grad(cfg, state["params"], b0)
    counts = env.read(kernel)
    bad = [tree.path_str(p) for p, g in tree.flatten_with_paths(grads)
           if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    if bad:
        raise AssertionError(f"{what}: gradients not finite or all zero: "
                             f"{bad[:8]} ({len(bad)} leaves)")
    only = p12_kernel_only(cfg, grads)
    if min(only.values()) <= 0:
        raise AssertionError(f"{what}: a gradient reaching the loss only "
                             f"through {kernel} is zero: {only}")
    n_leaves = len(tree.leaves(grads))
    del grads
    print(f"phase 12: {what}: loss {float(loss):.4f}; all {n_leaves} "
          f"gradient leaves finite and nonzero; reaching the loss only "
          f"through {kernel} (smallest norm over {cfg.num_layers} layers): "
          + ", ".join(f"{k} {v:.4e}" for k, v in only.items())
          + f"; {kernel} launches {counts['launches']}, backward recomputes "
          f"{counts['recomputes']} on {env.card}", flush=True)
    if counts != want:
        raise AssertionError(f"{what}: one loss/backward counted {counts}, "
                             f"the dry run predicts {want}")
    out.update(kernel_only=only, grad_leaves=n_leaves)

    # n_steps train steps on b0: the loss falls; counts per step
    step = S.make_train_step(cfg, opt)
    losses, times = [], []
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    env.reset()
    for _ in range(n_steps):
        env.sync()
        t0 = time.perf_counter()
        state, met = step(state, b0)
        losses.append(float(met["loss"]))
        env.sync()
        times.append(time.perf_counter() - t0)
    counts = env.read(kernel)
    per_step = {k: v / n_steps for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    step_s = sorted(times[1:])[len(times[1:]) // 2]      # median after warm-up
    print(f"phase 12: {what}: {n_steps} steps on one batch, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step_s after a warm-up "
          f"step {step_s:.4f} (first {times[0]:.4f}, all "
          f"{[round(t, 4) for t in times]}); tokens/s "
          f"{batch * seq / step_s:.1f}; max_memory_allocated {peak} B; "
          f"{kernel} per step {per_step} on {env.card}", flush=True)
    if per_step != want:
        raise AssertionError(f"{what}: per step {per_step}, the dry run "
                             f"predicts {want}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    out.update(losses=losses, step_s=step_s, first_step_s=times[0],
               tokens_per_s=batch * seq / step_s, peak_bytes=peak,
               per_step=per_step)
    if dev == "cuda":
        share = p12_recompute_share(torch, lambda: step(state, b0))
        if share is None:
            print(f"phase 12: {what}: recompute share not measured (no "
                  "Kernel*Backward node in the trace)", flush=True)
        else:
            print(f"phase 12: {what}: torch.profiler, one step: device "
                  f"{share[1]:.2f} ms, of which the kernels' backward "
                  f"(plain-twin recompute + VJP) {share[0]:.2f} ms = "
                  f"{100 * share[0] / share[1]:.1f}% on {env.card}",
                  flush=True)
            out["recompute_ms"], out["step_device_ms"] = share
    del state

    if int8:
        cstate = S.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), opt,
            compression="int8", device=dev)
        p = cstate["params"]
        n_pre, pat = len(cfg.prefix), len(cfg.pattern)
        reps = (list(range(n_pre + pat))
                + list(range(cfg.num_layers - len(cfg.tail_specs),
                             cfg.num_layers)))
        ref_leaves = (len(tree.leaves({k: v for k, v in p.items()
                                       if k != "layers"}))
                      + sum(len(tree.leaves(p["layers"][i])) for i in reps))
        numel = sum(t.numel() for t in tree.leaves(p))
        formula = numel + 4 * ref_leaves
        _, met = S.make_train_step(cfg, opt, compression="int8")(cstate, b0)
        del cstate
        print(f"phase 12: {what}: int8-compressed step loss "
              f"{float(met['loss']):.4f}, wire_bytes {met['wire_bytes']} = "
              f"{numel} + 4 x {ref_leaves} stacked leaves (the reference's "
              f"formula: {formula})", flush=True)
        if met["wire_bytes"] != formula:
            raise AssertionError(f"{what}: wire_bytes {met['wire_bytes']} "
                                 f"!= {formula}")
        out["wire_bytes"] = formula

    if restart:
        out.update(p12_restart(env, cfg, f"phase 12: {what}", batch, seq,
                               work, P12_RESTART))
    return out


def p12_restart(env, cfg, label, batch, seq, work, plan):
    """``train_with_restarts`` with a failure injected after a checkpoint
    (``plan``: steps, checkpoint every, failure at) against an
    uninterrupted ``train``: the restart resumes at the checkpoint, takes
    each later batch once, and ends bit for bit where the uninterrupted run
    ends (checkpoints under ``work`` in the reference's stacked layout).
    Returns the largest differences and the seconds."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, TokenSource
    from repro_torch.launch import train as TR
    total, every, fail_at = plan
    src = TokenSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch))
    ck = Path(work) / f"ckpt-{cfg.name}"
    run = dict(cfg=cfg, total_steps=total, global_batch=batch, seq_len=seq,
               ckpt_every=every, device=env.device, log_every=100,
               peak_lr=P12_LR)
    t0 = time.perf_counter()
    got = TR.train_with_restarts(TR.TrainRun(**run, ckpt_dir=str(ck),
                                             fail_at_step=fail_at))
    restart_s = time.perf_counter() - t0
    got_state = [t.cpu() for t in tree.leaves(got.pop("state"))]
    clean = TR.train(TR.TrainRun(**run))
    clean_state = [t.cpu() for t in tree.leaves(clean.pop("state"))]
    expect = [(s, int(src.batch_at(s, 0)["tokens"].sum()))
              for s in range(every, total)]
    diff = max(abs(a - b) for a, b in zip(got["losses"],
                                          clean["losses"][every:]))
    state_diff = max(float((a.double() - b.double()).abs().max())
                     for a, b in zip(got_state, clean_state))
    print(f"{label}: train_with_restarts {total} steps, checkpoint every "
          f"{every}, failure injected at step {fail_at}: restored step "
          f"{got['start_step']}, then took steps "
          f"{[s for s, _ in got['taken']]} once each (token sums "
          f"{[t for _, t in got['taken']]}, TokenSource.batch_at's "
          f"{[t for _, t in expect]}); final loss {got['losses'][-1]:.6f} "
          f"vs an uninterrupted run's {clean['losses'][-1]:.6f}; largest "
          f"|diff| over the {len(got['losses'])} losses after the restore "
          f"{diff:.3e}, over the {len(got_state)} leaves of the final state "
          f"{state_diff:.3e} (limit {P12_RESTART_TOL}); {restart_s:.1f} s "
          f"with the restart and checkpoints on {env.card}", flush=True)
    if got["start_step"] != every or got["taken"] != expect:
        raise AssertionError(f"{label}: the restart resumed at "
                             f"{got['start_step']} with {got['taken']}")
    if len(got_state) != len(clean_state) or len(got["losses"]) != \
            total - every:
        raise AssertionError(f"{label}: the restarted run's state or "
                             "losses do not line up with the "
                             "uninterrupted run's")
    if not max(diff, state_diff) <= P12_RESTART_TOL:
        raise AssertionError(f"{label}: the restarted run differs from "
                             f"an uninterrupted one: losses by {diff}, "
                             f"the final state by {state_diff}")
    return {"restart_loss_diff": diff, "restart_state_diff": state_diff,
            "restart_s": restart_s}


#: one layer's kernel shapes in phase 12's models: SSD (B, T, H, P, N,
#: chunk) of mamba2-370m at batch 8 × 2048; attention (B, H, KV, S, hd) of
#: internlm2-1.8b at batch 4 × 2048
P12_VJP_SHAPES = {"ssd_scan": (8, 2048, 32, 64, 128, 256),
                  "flash_attention": (4, 16, 8, 2048, 128)}


def p12_vjp(torch, kernel, gen):
    """A kernel Function at one layer's shape of the phase's model (bf16;
    on ``gen``'s device): its forward (the kernel) held against the plain
    twin as phases 5 and 6 hold it — the reference's allclose and relative
    RMS <= RMS_LIMIT on every output — then its gradient against the
    twin's VJP.  Returns ({output: max abs err}, {output: relative RMS},
    {input: max gradient difference / max |grad|})."""
    dev = gen.device
    shape = P12_VJP_SHAPES[kernel]
    if kernel == "ssd_scan":
        from repro_torch.kernels.ssd_scan import ops, ref
        B, T, H, P, N, L = shape
        ins = ssd_inputs(torch, gen, B, T, H, P, N, torch.bfloat16)
        fn = lambda *a: ops.KernelSSD.apply(*a, L)        # noqa: E731
        twin = lambda *a: ref.ssd_ref(*a, L)              # noqa: E731
        names, outputs, tol = ("x", "dt", "A", "B", "C"), ("y", "state"), \
            TOL["bfloat16"][1]
    else:
        from repro_torch.kernels.flash_attention import ops, ref
        B, H, KV, S, hd = shape
        ins = [torch.randn(shp, generator=gen, device=dev
                           ).to(torch.bfloat16).transpose(1, 2)
               for shp in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
        fn = lambda *a: (ops.KernelAttention.apply(  # noqa: E731
            *a, True, None, 0.0, None),)
        twin = lambda *a: (ref.attention_ref(*a),)     # noqa: E731
        names, outputs, tol = ("q", "k", "v"), ("out",), TOL["bfloat16"][0]
    ins = [t.detach().requires_grad_() for t in ins]
    outs = fn(*ins)
    plain = twin(*ins)
    errs, rms = {}, {}
    for name, o, w in zip(outputs, outs, plain):
        if o.grad_fn is None:
            raise AssertionError(f"{kernel}: output {name} of its Function "
                                 "has no grad_fn")
        errs[name] = check_close(torch, o.detach(), w.detach(), tol,
                                 f"{kernel} {name} at {shape}")
        rms[name] = rel_rms(torch, o.detach(), w.detach())
        if not rms[name] <= RMS_LIMIT:
            raise AssertionError(f"{kernel} {name} at {shape}: relative RMS "
                                 f"error {rms[name]} above {RMS_LIMIT}")
    cots = [torch.randn(o.shape, generator=gen, device=dev).to(o.dtype)
            for o in outs]
    got = torch.autograd.grad(outs, ins, cots)
    want = torch.autograd.grad(plain, ins, cots)
    grads = {}
    for name, g, w in zip(names, got, want):
        scale = float(w.float().abs().max())
        grads[name] = float((g.float() - w.float()).abs().max()) / max(
            scale, 1e-30)
        if not bool(torch.isfinite(g).all()) or scale == 0:
            raise AssertionError(f"{kernel}: gradient of {name} not finite "
                                 "or zero")
    if max(grads.values()) > P12_VJP_TOL:
        raise AssertionError(f"{kernel}: Function gradient vs the plain "
                             f"twin's VJP: {grads} (limit {P12_VJP_TOL})")
    return errs, rms, grads


def p12_agents(np, torch, drl_env, agent_mod, fig, card):
    """The card agent against a CPU agent holding the same weights: the
    forward pass (unmasked logits and values), then one ``train_batch``
    on the same transitions."""
    queries, cfg = drl_env.tpch_like_library(seed=11)
    sim = drl_env.TraceSimulator(queries, cfg)
    cpu = agent_mod.A3CAgent(fig["agent"].cfg, device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in
                             fig["agent"].net.state_dict().items()})
    probe = agent_mod.A3CAgent(fig["agent"].cfg, device="cuda")
    probe.net.load_state_dict(fig["agent"].net.state_dict())
    rows = []
    for _ in range(16):
        wl = sim.sample_workload()
        s, m = sim.state_of(wl)
        a = int(np.flatnonzero(m)[0])
        rows.append(agent_mod.Transition(s, a, sim.reward_of(wl, a), m))
    st = torch.from_numpy(np.stack([r.state for r in rows]))
    with torch.no_grad():
        lc, vc = cpu.net(st)
        lg, vg = probe.net(st.cuda())
    fwd = max(float((lg.cpu() - lc).abs().max() / lc.abs().max()),
              float((vg.cpu() - vc).abs().max() / vc.abs().max()))
    lcpu, _ = cpu.train_batch(rows)
    lgpu, _ = probe.train_batch(rows)
    par = max(float((a.detach().cpu() - b.detach()).abs().max())
              for a, b in zip(probe.params, cpu.params))
    print(f"phase 12: (a) card agent vs a CPU agent from the same weights: "
          f"forward max rel err {fwd:.3e} (limit {P12_AGENT_TOL[0]}); one "
          f"train_batch loss {lgpu:.6f} vs {lcpu:.6f}, params max abs err "
          f"{par:.3e} (limit {P12_AGENT_TOL[1]}) on {card}", flush=True)
    if fwd > P12_AGENT_TOL[0] or par > P12_AGENT_TOL[1]:
        raise AssertionError("the card agent disagrees with the CPU agent")
    return cpu


def p12_decide(np, lt, tcore, HistoryStore, card_agent, cpu_agent, card):
    """``partitioning_creation`` over a q04-like history (phase 9's helper,
    TPC-H SF 0.01, on the card with the device backend) with
    ``DRLSelector`` of each agent: the same action."""
    import tempfile
    orders, lineitem, _part = tpch_tables(np, 0.01)
    with tempfile.TemporaryDirectory() as tmp:
        hist = p9_history(np, lt, tcore, HistoryStore, "device",
                          str(Path(tmp) / "history.jsonl"),
                          {"orders": orders, "lineitem": lineitem})
        loader = p9_loader(lt.Workload)
        decs = [tcore.partitioning_creation(
            loader, "lineitem", hist, selector=tcore.DRLSelector(agent),
            dataset_bytes=float(sum(v.nbytes for v in lineitem.values())),
            now=1000.0) for agent in (card_agent, cpu_agent)]
    acts = [d.action_index for d in decs]
    print(f"phase 12: (a) DRLSelector over a q04-like history "
          f"({len(decs[0].features)} candidates): card agent action "
          f"{acts[0]} ({decs[0].candidate.signature()}), CPU agent action "
          f"{acts[1]} on {card}", flush=True)
    if acts[0] != acts[1] or not np.array_equal(decs[0].state,
                                                decs[1].state):
        raise AssertionError(f"the DRL selectors disagree: {acts}")
    return acts[0]


def run_training(torch, np, lt, tcore, card):
    """Phase 12 on the card: (a) the DRL selector (Fig. 12, the card agent
    against a CPU agent, the advisor's decision); (b)-(c) the LMs'
    training.  Returns each LM's kernel launches over its main path."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.drl import agent as agent_mod
    from repro_torch.core.drl import env as drl_env
    from repro_torch.core.history import HistoryStore

    # float32 GEMMs in full float32 (the agent's parity with the CPU)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fig = p12_fig12(np, drl_env, agent_mod, "cuda")
    print(f"phase 12: (a) Fig. 12 on the card: {P12_EPOCHS} epochs of "
          f"{P12_BATCH} transitions, reward {fig['reward_before']:.4f} -> "
          f"{fig['reward_after']:.4f} (oracle {fig['oracle']:.4f}), loss "
          f"{fig['losses'][0]:.4f} -> {fig['losses'][-1]:.4f}, "
          f"{fig['epoch_s']:.4f} s per epoch on {card}", flush=True)
    if not fig["reward_after"] > fig["reward_before"]:
        raise AssertionError("DRL training must improve the policy")
    cpu_agent = p12_agents(np, torch, drl_env, agent_mod, fig, card)
    p12_decide(np, lt, tcore, HistoryStore, fig["agent"], cpu_agent, card)
    print(f"phase 12: (a) done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(12)
    for kernel in ("ssd_scan", "flash_attention"):
        errs, rms, grads = p12_vjp(torch, kernel, gen)
        print(f"phase 12: {kernel} Function at one layer's shape "
              f"{P12_VJP_SHAPES[kernel]} (bf16): forward (the kernel) vs the "
              f"plain twin: "
              + ", ".join(f"{k} max_abs_err {errs[k]:.3e} rel_rms "
                          f"{rms[k]:.3e}" for k in errs)
              + f" (limits atol=rtol {TOL['bfloat16'][kernel == 'ssd_scan']}"
              f", rel_rms {RMS_LIMIT}); gradient vs the twin's VJP, max abs "
              f"err / max |grad| "
              + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
              + f" (limit {P12_VJP_TOL}) on {card}", flush=True)

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    need = 3 * 3 * 2 * 368_000_000 + P12_SLACK_BYTES
    free = shutil.disk_usage(build).free
    if free < need:
        raise AssertionError(f"phase 12 needs {need} B of free disk under "
                             f"{build}, and {free} B are free")
    env = p12_env(torch, np, "cuda", card)
    launches = {}
    tmp = Path(tempfile.mkdtemp(prefix="phase12-", dir=build))
    try:
        for arch, batch, seq, n_steps in P12_LM:
            tl = time.perf_counter()
            cfg = get_config(arch)
            mamba = cfg.ssd is not None
            out = p12_lm(env, cfg, arch, batch, seq, n_steps, tmp,
                         restart=mamba, int8=mamba)
            kernel = "ssd_scan" if mamba else "flash_attention"
            launches[kernel] = int(out["per_step"]["launches"] * n_steps)
            print(f"phase 12: {arch} done in {time.perf_counter() - tl:.1f} "
                  "s", flush=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- phase 13: mesh placement, the MoE and MLA layers at full width -----------

# deepseek-v2's MLA prefill at phase 7's shape: B, H, S, nope, rope, v
P13_MLA = (SERVE_BATCH, 128, PROMPT_LEN, 128, 64, 128)
P13_MLA_HELD = 16                   # heads of batch row 0 held to the twin
# (arch, layers kept, dtypes, decode-against-prefill shape B, S, steps):
# each model at full width, cut in depth only; llama4-maverick's 35.04 B
# parameters take 70.1 GB in bf16, so float32 (140 GB) cannot run
P13_LM = (
    ("deepseek-v2-236b", 3, ("bfloat16", "float32"), (2, 1024, 8)),
    ("llama4-maverick-400b-a17b", 4, ("bfloat16",), (2, 512, 8)),
    ("chameleon-34b", 2, ("bfloat16",), (SERVE_BATCH, PROMPT_LEN, 8)),
)
# phase 7's limits; the float32 check reaches the last decode step
P13_CHECKS = {"bfloat16": ((0, 1), 5e-2), "float32": ((0, 7), 1e-3)}


def p13_mesh(torch, np, lt, tcore, hp, lineitem, want, steps,
             export_layout, card, device="cuda"):
    """(a) Phase 4's SF-10 lineitem repartitioned d2d onto a one-device
    mesh, then once more through ``apply_decision(mesh=)``; returns the
    hash kernels' launches.  ``device="cpu"`` is the CPU dry run
    (``tests/test_torch_sharding.py``)."""
    from repro_torch.core.sharding_bridge import (Mesh, ShardedColumn,
                                                  sharding_for, sharding_of)
    mesh = Mesh([torch.device(device)], ("data",))
    wl = lt.Workload("sf10")
    li = wl.scan("lineitem")
    wl.partition(li["orderkey"])
    wl.partition(li["partkey"])
    by_order, by_part = tcore.enumerate_candidates(wl.graph, "lineitem")
    hp.reset_launches()
    sess = lt.Session(num_workers=M, device=device)
    sess.write("lineitem", lineitem, by_order)
    sess.store.synchronize()
    t0 = time.perf_counter()
    placed, moved = sess.repartition("lineitem", by_part, mesh=mesh,
                                     swap=False)
    sess.store.synchronize()
    t1 = time.perf_counter()
    dec = tcore.PartitioningDecision(
        dataset="lineitem", candidate=by_part, features=[], consumers=[],
        action_index=0, state=None, elapsed_s=0.0)
    applied, _ = tcore.apply_decision(sess.store, dec, mesh=mesh)
    sess.store.synchronize()
    t2 = time.perf_counter()
    launches = dict(hp.LAUNCHES)
    for what, ds in (("repartition(mesh=)", placed),
                     ("apply_decision(mesh=)", applied)):
        if sess.store.read(ds.name) is not ds:
            raise AssertionError(f"{what}: the store does not serve the "
                                 "placed generation")
        for k, col in ds.columns.items():
            if not isinstance(col, ShardedColumn) \
                    or col.devices != [mesh.devices.flat[0]]:
                raise AssertionError(f"{what}: column {k} is not on the "
                                     "mesh's device")
            if sharding_of(ds, k) != sharding_for(mesh, ds.partitioner,
                                                  extra_dims=col.dim() - 2):
                raise AssertionError(f"{what}: column {k} placed as "
                                     f"{sharding_of(ds, k)}")
        same_layout(np, export_layout(ds), want, f"phase 13 (a) {what}")
    expect = dict(steps["write"] + steps["repartition"]
                  + steps["repartition"])
    if {k: v for k, v in launches.items() if v} != expect:
        raise AssertionError(f"phase 13 (a): hash-kernel launches "
                             f"{launches}, phase 4's steps give {expect}")
    print(f"phase 13 (a): lineitem ({len(lineitem['orderkey'])} rows) d2d "
          "onto "
          f"{mesh}: repartition(mesh=) {t1 - t0:.4f} s, "
          f"apply_decision(mesh=) {t2 - t1:.4f} s, moved_bytes={moved}; "
          f"both layouts bit-equal to phase 4's host backend, every column "
          f"on {device} and placed as {sharding_for(mesh, by_part)}; "
          f"launches {launches} (phase 4's write + 2 repartitions) on {card}",
          flush=True)
    del sess, placed, applied
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


def p13_mla_route(torch, fa, fa_ref, mla, card):
    """The flash-attention kernel through MLA's padded route at
    deepseek-v2's prefill shape, in bf16 and float32, held to the plain
    twin on batch row 0's first heads (the twin's float32 scores at the
    whole shape would take 69 GB); bf16 timed."""
    B, H, S, nd, rd, vd = P13_MLA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    scale = 1.0 / math.sqrt(nd + rd)
    hd = mla.padded_head_dim(nd + rd, vd)
    row = {}
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        qn, qr, kn, v = (torch.randn((B, S, H, d), generator=gen, device=dev,
                                     dtype=dtype) for d in (nd, rd, nd, vd))
        kr = torch.randn((B, S, rd), generator=gen, device=dev, dtype=dtype)
        got = mla.padded_attention(qn, qr, kn, kr, v, scale)
        h = P13_MLA_HELD
        q = torch.cat([qn[:1, :, :h], qr[:1, :, :h]], -1).transpose(1, 2)
        k = torch.cat([kn[:1, :, :h], kr[:1, :, None].expand(1, S, h, rd)],
                      -1).transpose(1, 2)
        want = fa_ref.attention_ref(q, k, v[:1, :, :h].transpose(1, 2),
                                    causal=True, scale=scale).transpose(1, 2)
        held = got[:1, :, :h]
        err = check_close(torch, held, want, TOL[dname][0],
                          f"MLA padded route {dname}")
        rms = rel_rms(torch, held, want)
        if not rms <= RMS_LIMIT:
            raise AssertionError(f"MLA padded route {dname}: relative RMS "
                                 f"error {rms} above {RMS_LIMIT}")
        print(f"phase 13: flash_attention via MLA's padded route B={B} H={H} "
              f"S={S} q·k {nd}+{rd}, v {vd} → hd {hd}, {dname}: batch row 0, "
              f"heads 0..{h - 1} against the plain twin: max_abs_err={err:.3e} "
              f"rel_rms={rms:.3e}", flush=True)
        del got, held, want, q, k
        if dname == "float32":
            del qn, qr, kn, kr, v
            torch.cuda.empty_cache()
    # the kernel alone on the padded buffers, the route (padding copies
    # included) and SDPA on the same padded tensors
    pad = [t.new_zeros((B, S, H, hd)) for t in (qn, kn, v)]
    pad[0][..., :nd], pad[0][..., nd:nd + rd] = qn, qr
    pad[1][..., :nd], pad[1][..., nd:nd + rd] = kn, kr[:, :, None]
    pad[2][..., :vd] = v
    q, k, vp = (t.transpose(1, 2) for t in pad)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    flops = 2.0 * B * H * S * (S + 1) / 2 * (nd + rd + vd)
    nbytes = 2 * (B * S * H * (2 * nd + rd + 2 * vd) + B * S * rd)
    row["ms"] = time_ms(torch, lambda: fa.flash_attention(
        q, k, vp, causal=True, scale=scale), flush, reps=5, warmup=1)
    row["route_ms"] = time_ms(torch, lambda: mla.padded_attention(
        qn, qr, kn, kr, v, scale), flush, reps=5, warmup=1)
    row["bound_ms"] = max(flops / BF16_FLOP_PER_S,
                          nbytes / HBM_BYTES_PER_S) * 1e3
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            row["library_ms"] = time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, vp, is_causal=True, scale=scale), flush, reps=5,
                warmup=1)
    except RuntimeError as exc:
        row["library_ms"] = None
        print(f"phase 13: SDPA at the padded MLA shape: {exc}", flush=True)
    lib = row["library_ms"]
    print(f"phase 13: flash_attention via MLA's padded route bf16: kernel_ms="
          f"{row['ms']:.4f} route_ms={row['route_ms']:.4f} bound_ms="
          f"{row['bound_ms']:.4f} (operations: {flops:.4g} FLOP over q·k "
          f"{nd + rd} and v {vd}, unpadded; {nbytes} B) library_ms="
          f"{'null' if lib is None else f'{lib:.4f}'} (SDPA, flash or "
          f"efficient backend, on the padded tensors) on {card}", flush=True)
    del q, k, vp, pad, qn, qr, kn, kr, v, flush
    torch.cuda.empty_cache()
    return row


def p13_decode_check(torch, np, T, cfg, params, shape, dname):
    """Decode logits against a prefill over the same tokens, with a
    capacity factor of E / top_k where no token can be dropped (at 1.25 a
    prefill drops and a decode step does not: the two legitimately
    differ).  Runs where ``params`` are (the CPU in
    ``tests/test_torch_moe.py``)."""
    import dataclasses
    dev = params["embed"]["table"].device
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    positions, limit = P13_CHECKS[dname]
    B, S, G = shape
    prompts = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)).to(dev)

    def dropped(aux):
        d = [float(x) for x in aux["dropped_frac"]]
        if any(d):
            raise AssertionError(f"{cfg.name}: {d} dropped at capacity "
                                 "factor E / top_k")
    with torch.inference_mode():
        logits, cache, aux = T.prefill(cfg, params, prompts,
                                       cache_len=S + G, with_aux=True)
        dropped(aux)
        toks, kept = [], {}
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for i in range(G):
            toks.append(tok)
            logits, cache = T.decode_step(cfg, params, cache, tok, S + i)
            if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
                raise AssertionError(f"{cfg.name}: non-finite logits at "
                                     f"decode step {i}")
            if i in positions:
                kept[i] = logits
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        del cache
        for i, got in sorted(kept.items()):
            seq = torch.cat([prompts] + toks[:i + 1], 1)
            ref, _, aux = T.prefill(cfg, params, seq, with_aux=True)
            dropped(aux)
            got = got[:, :cfg.vocab_size].float()
            ref = ref[:, :cfg.vocab_size].float()
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            print(f"phase 13: {cfg.name} {dname} decode step {i} vs prefill "
                  f"of {seq.shape[1]} tokens (batch {B}, prompt {S}"
                  + (f", capacity factor {cfg.moe.capacity_factor:g}: no "
                     "drops" if cfg.moe else "")
                  + f"): max_abs_err={err:.4e} (logits max-abs {scale:.4e}; "
                  f"limit {limit} of it)", flush=True)
            if not (math.isfinite(err) and err <= limit * scale):
                raise AssertionError(f"{cfg.name} {dname}: decode step {i} "
                                     f"logits differ from prefill by {err}")


def p13_lm(torch, np, T, serve, get_config, counters, fa, arch, layers,
           dtypes, check, card):
    """(b)-(d): ``serve_batch`` at full width with ``layers`` layers kept,
    seeded random weights, batch 8, prompt 4096, 32 tokens; flash launches
    once per attention layer in the prefill; the MoE drop fractions at the
    configured capacity; decode against prefill.  Returns the bf16 serve's
    flash launches."""
    import dataclasses
    dev = torch.device("cuda")
    launched = 0
    for dname in dtypes:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), param_dtype=dname,
                                  num_layers=layers)
        torch.cuda.empty_cache()
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"phase 13: {arch} {dname}, {layers} layers "
              f"({', '.join(f'{s.mixer}/{s.ffn}' for s in cfg.all_specs)}): "
              f"{cfg.param_count()} parameters, "
              f"{torch.cuda.memory_allocated()} B on the card, initialised "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), dtype=np.int32)
        torch.cuda.reset_peak_memory_stats()
        for reset, _ in counters:
            reset()
        out, stats = serve.serve_batch(cfg, params, prompts, GEN, device=dev)
        flash = fa.LAUNCHES["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        print(f"phase 13: {arch} {dname} serve_batch batch={SERVE_BATCH} "
              f"prompt={PROMPT_LEN} gen={GEN}: "
              f"prefill_s={stats['prefill_s']:.4f} "
              f"decode_s={stats['decode_s']:.4f} "
              f"decode_tokens_per_s={stats['tokens_per_s']:.1f} "
              f"max_memory_allocated={peak} flash_attention launches={flash} "
              f"on {card}", flush=True)
        if flash != layers:
            raise AssertionError(f"{arch} {dname}: flash_attention launched "
                                 f"{flash} times in one prefill, not once per "
                                 f"attention layer ({layers})")
        if out.shape != (SERVE_BATCH, GEN) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise AssertionError(f"{arch}: bad generated ids {out.shape}")
        if dname == "bfloat16":
            launched += flash
            if cfg.moe is not None:
                with torch.inference_mode():
                    _, _, aux = T.prefill(cfg, params,
                                          torch.from_numpy(prompts).to(dev),
                                          with_aux=True)
                print(f"phase 13: {arch} prefill at capacity factor "
                      f"{cfg.moe.capacity_factor}: dropped_frac per MoE layer "
                      f"{[round(float(d), 6) for d in aux['dropped_frac']]}, "
                      f"load_balance_loss (summed) "
                      f"{float(aux['load_balance_loss']):.6f}", flush=True)
                del aux
        p13_decode_check(torch, np, T, cfg, params, check, dname)
        del params
        torch.cuda.empty_cache()
        print(f"phase 13: {arch} {dname} done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launched


# -- phase 14: the RG-LRU mixer, ring caches, the encoder and cross-attention --

F32_FLOP_PER_S = 67e12              # H100 SXM float32 outside the tensor cores
# (label, (B, H, KV, Sq, Skv, hd, causal, window)): the flash kernel at the
# prefill shapes of recurrentgemma-9b's local layers and whisper-small's
# encoder and cross-attention
P14_FLASH = (
    ("recurrentgemma-9b local layer", (4, 16, 1, 4096, 4096, 256, True, 2048)),
    ("whisper-small encoder", (8, 12, 12, 1500, 1500, 64, False, None)),
    ("whisper-small cross-attention", (8, 12, 12, 224, 1500, 64, False,
                                       None)),
)
# (arch, batch, prompt, tokens): serve_batch at full width and depth
P14_RG = ("recurrentgemma-9b", 4, 4096, 32)
P14_WHISPER = ("whisper-small", 8, 224, 32)
# recurrentgemma decode against prefill at depth 5 (one rglru, rglru, attn
# period and the 2-layer recurrent tail): (batch, prompt, steps), the ring
# (2048 slots) wrapping in decode, then in the prefill
P14_RG_DEPTH = 5
P14_RG_CHECKS = ((4, 2040, 16), (4, 4096, 8))


def p14_flash(torch, fa, fa_ref, card):
    """(a) The flash kernel at the three new shapes, float32 and bf16,
    held to the plain twin within phase 5's limits and timed beside the
    twin and one SDPA call on the same tensors; returns the bf16 rows."""
    from repro_torch.kernels.cost import (attention_pairs,
                                          flash_attention_cost)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    rows = {}
    for what, (B, H, KV, Sq, Skv, hd, causal, window) in P14_FLASH:
        pairs = attention_pairs(Sq, Skv, causal, window)
        mask = None
        if window is not None:
            qp = torch.arange(Sq, device=dev)[:, None]
            kp = torch.arange(Skv, device=dev)[None, :]
            mask = (kp <= qp) & (qp - kp < window)
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=dev)
                       .to(dtype).transpose(1, 2)
                       for S, n in ((Sq, H), (Skv, KV), (Skv, KV)))
            kw = dict(causal=causal, window=window)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa_ref.attention_ref(q, k, v, **kw)
            err = check_close(torch, got, want, TOL[dname][0],
                              f"phase 14 flash_attention {what} {dname}")
            rms = rel_rms(torch, got, want)
            if dname == "bfloat16" and not rms <= RMS_LIMIT:
                raise AssertionError(f"phase 14 flash_attention {what}: "
                                     f"relative RMS error {rms} above "
                                     f"{RMS_LIMIT}")
            del got, want
            torch.cuda.empty_cache()
            flops, nbytes = flash_attention_cost(B, H, KV, Sq, Skv, hd,
                                                 causal, window,
                                                 q.element_size())
            peak = BF16_FLOP_PER_S if dname == "bfloat16" else F32_FLOP_PER_S
            bound = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
            row = {
                "max_abs_err": err, "rel_rms": rms, "bound_ms": bound,
                "bound_by": ("operations" if flops / peak
                             > nbytes / HBM_BYTES_PER_S else "bytes"),
                "ms": time_ms(torch, lambda: fa.flash_attention(
                    q, k, v, **kw), flush, reps=10),
                "plain_ms": time_ms(torch, lambda: fa_ref.attention_ref(
                    q, k, v, **kw), flush, reps=3, warmup=1)}
            try:
                row["library_ms"] = time_ms(
                    torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(
                        q, k, v, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=True),
                    flush, reps=10)
            except RuntimeError as exc:
                row["library_ms"] = None
                print(f"phase 14: SDPA at {what} {dname}: {exc}", flush=True)
            lib = row["library_ms"]
            print(f"phase 14: (a) flash_attention {what} B={B} H={H} KV={KV} "
                  f"Sq={Sq} Skv={Skv} hd={hd} causal={causal} "
                  f"window={window} {dname}: max_abs_err={err:.3e} "
                  f"rel_rms={rms:.3e} kernel_ms={row['ms']:.4f} "
                  f"bound_ms={bound:.4f} ({row['bound_by']}: {flops:.4g} "
                  f"FLOP over {pairs} kept pairs a head, {nbytes} B) "
                  f"plain_ms={row['plain_ms']:.4f} library_ms="
                  f"{'null' if lib is None else f'{lib:.4f}'} (SDPA"
                  + (", boolean window mask" if mask is not None else "")
                  + f") on {card}", flush=True)
            if dname == "bfloat16":
                rows[what] = row
            del q, k, v
            torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return rows


def p14_decode_check(torch, np, T, cfg, params, shape, dname, frames=None,
                     held=True):
    """Greedy decode logits against a prefill over the same tokens (and
    frames), phase 7's limits: bf16 steps 0 and 1, float32 steps 0 and
    the last, held where ``held``; the last step is printed always.  Runs
    where ``params`` are (the CPU in ``tests/test_torch_models.py``)."""
    dev = params["embed"]["table"].device
    B, S, G = shape
    limit = DECODE_CHECKS[dname][1]
    gated = ({0, 1} if dname == "bfloat16" else {0, G - 1}) if held else set()
    prompts = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)).to(dev)
    worst = 0.0
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, prompts, frames=frames,
                                  cache_len=S + G)
        toks, kept = [], {}
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        for i in range(G):
            toks.append(tok)
            logits, cache = T.decode_step(cfg, params, cache, tok, S + i)
            if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
                raise AssertionError(f"{cfg.name}: non-finite logits at "
                                     f"decode step {i}")
            if i in gated or i == G - 1:
                kept[i] = logits
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        del cache
        for i, got in sorted(kept.items()):
            seq = torch.cat([prompts] + toks[:i + 1], 1)
            ref, _ = T.prefill(cfg, params, seq, frames=frames)
            got = got[:, :cfg.vocab_size].float()
            ref = ref[:, :cfg.vocab_size].float()
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            print(f"phase 14: {cfg.name} {dname} ({cfg.num_layers} layers) "
                  f"decode step {i} (position {S + i}) vs prefill of "
                  f"{seq.shape[1]} tokens (batch {B}): max_abs_err="
                  f"{err:.4e} (logits max-abs {scale:.4e}; "
                  + (f"limit {limit} of it)" if i in gated else
                     "printed, not held)"), flush=True)
            if i in gated:
                if not (math.isfinite(err) and err <= limit * scale):
                    raise AssertionError(f"{cfg.name} {dname}: decode step "
                                         f"{i} logits differ from prefill "
                                         f"by {err}")
                worst = max(worst, err / scale)
    return worst


def p14_serve(torch, np, T, serve, cfg, counters, fa, shape, card,
              frames=None):
    """``serve_batch`` with seeded random weights; flash must launch once
    per attention layer, encoder layer and cross-attention in the prefill.
    Returns (params, generated ids, flash launches)."""
    dev = torch.device("cuda")
    B, S, G = shape
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    print(f"phase 14: {cfg.name} {cfg.param_dtype}, {cfg.num_layers} layers"
          + (f" + {cfg.encoder.num_layers} encoder layers" if cfg.encoder
             else "")
          + f": {cfg.param_count()} parameters, "
          f"{torch.cuda.memory_allocated()} B on the card, initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    for reset, _ in counters:
        reset()
    out, stats = serve.serve_batch(cfg, params, prompts, G, frames=frames,
                                   device=dev)
    flash = fa.LAUNCHES["flash_attention"]
    expect = sum(s.mixer == "attn" for s in cfg.all_specs)
    if cfg.encoder is not None:
        expect += cfg.encoder.num_layers + cfg.num_layers
    print(f"phase 14: {cfg.name} {cfg.param_dtype} serve_batch batch={B} "
          f"prompt={S} gen={G}: prefill_s={stats['prefill_s']:.4f} "
          f"decode_s={stats['decode_s']:.4f} "
          f"decode_tokens_per_s={stats['tokens_per_s']:.1f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"flash_attention launches={flash} (expected {expect}) on {card}",
          flush=True)
    if flash != expect:
        raise AssertionError(f"{cfg.name} {cfg.param_dtype}: flash_attention "
                             f"launched {flash} times in one prefill, not "
                             f"{expect}")
    if out.shape != (B, G) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: bad generated ids {out.shape}")
    return params, prompts, flash


def p14_recurrentgemma(torch, np, T, RG, serve, get_config, counters, fa,
                       card):
    """(b) recurrentgemma-9b at full width and depth in bf16: serve, a
    traced prefill (each local layer's ring cache must hold 2048 slots),
    the RG-LRU pieces at their prefill shape timed, and the bf16
    decode-against-prefill gap at full depth printed.  (c) decode against
    prefill at depth 5, float32 and bf16, held.  Returns the bf16 serve's
    flash launches."""
    import dataclasses
    dev = torch.device("cuda")
    arch, B, S, G = P14_RG
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    params, prompts, flash = p14_serve(torch, np, T, serve, cfg, counters,
                                       fa, (B, S, G), card)
    with torch.inference_mode():
        toks = torch.from_numpy(prompts).to(dev)
        (_, cache), busy, wall, by_name = device_busy(
            torch, lambda: T.prefill(cfg, params, toks, cache_len=S + G))
        lengths = [c["k"].shape[1] for c, spec in zip(cache, cfg.all_specs)
                   if spec.mixer == "attn"]
        del cache
    print(f"phase 14: (b) {arch} prefill of {S} tokens traced: device busy "
          f"{busy:.1f} ms of {wall:.1f} ms wall; top " + "; ".join(
              f"{k[:60]} {v:.2f} ms"
              for k, v in Counter(by_name).most_common(4))
          + f"; local layers' cache lengths {lengths} (window "
          f"{cfg.sliding_window}, cache_len {S + G})", flush=True)
    if len(lengths) != 12 or set(lengths) != {cfg.sliding_window}:
        raise AssertionError(f"{arch}: local caches {lengths}, not 12 rings "
                             f"of {cfg.sliding_window}")
    # the RG-LRU pieces of one layer at the prefill's shape, CUDA events:
    # the depthwise conv, the gates (two width x width GEMMs and the
    # elementwise coefficients) and the log-depth scan over float32 (a, b)
    p = params["layers"][0]["attn"]
    W = cfg.rglru.width
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    with torch.inference_mode():
        x = torch.randn((B, S, W), generator=torch.Generator(device=dev)
                        .manual_seed(14), device=dev).to(torch.bfloat16)
        a, b = RG._rglru_coeffs(p, x)
        conv_ms = time_ms(torch, lambda: RG._causal_conv1d(
            x, p["conv_w"], p["conv_b"]), flush, reps=10)
        coeff_ms = time_ms(torch, lambda: RG._rglru_coeffs(p, x), flush,
                           reps=10)
        scan_ms = time_ms(torch, lambda: RG.linear_scan(a, b), flush,
                          reps=10)
    scan_bytes = 3 * a.numel() * 4          # a and b read, h written
    conv_bytes = 2 * x.numel() * 2
    print(f"phase 14: (b) RG-LRU pieces of one layer, B={B} T={S} width={W} "
          f"bf16: conv1d_ms={conv_ms:.4f} (bound "
          f"{conv_bytes / HBM_BYTES_PER_S * 1e3:.4f}, bytes) gates_ms="
          f"{coeff_ms:.4f} linear_scan_ms={scan_ms:.4f} (float32, "
          f"{math.ceil(math.log2(S))} passes; bound "
          f"{scan_bytes / HBM_BYTES_PER_S * 1e3:.4f}, bytes: a and b read "
          f"once, h written once); x 26 recurrent layers a prefill on {card}",
          flush=True)
    del x, a, b, flush, p
    torch.cuda.empty_cache()
    p14_decode_check(torch, np, T, cfg, params, (B, S, 8), "bfloat16",
                     held=False)
    del params
    torch.cuda.empty_cache()
    for dname in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        cut = dataclasses.replace(get_config(arch), param_dtype=dname,
                                  num_layers=P14_RG_DEPTH)
        params = T.init_params(
            cut, torch.Generator(device=dev).manual_seed(1), dev)
        for shape in P14_RG_CHECKS:
            p14_decode_check(torch, np, T, cut, params, shape, dname)
        del params
        torch.cuda.empty_cache()
        print(f"phase 14: (c) {arch} {dname} at depth {P14_RG_DEPTH} "
              f"({', '.join(s.mixer for s in cut.all_specs)}) done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return flash


def p14_whisper(torch, np, T, serve, get_config, counters, fa, card):
    """(d) whisper-small at full width and depth, bf16 and float32:
    ``serve_batch`` over seeded random frames, flash launched 36 times a
    prefill, decode against prefill held.  Returns the bf16 serve's flash
    launches."""
    import dataclasses
    dev = torch.device("cuda")
    arch, B, S, G = P14_WHISPER
    launched = 0
    for dname in DECODE_CHECKS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), param_dtype=dname)
        frames = torch.randn(
            (B, cfg.encoder.num_frames, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(14)
        ).to(getattr(torch, dname))
        params, _, flash = p14_serve(torch, np, T, serve, cfg, counters, fa,
                                     (B, S, G), card, frames=frames)
        if dname == "bfloat16":
            launched += flash
        p14_decode_check(torch, np, T, cfg, params, (B, S, G), dname,
                         frames=frames)
        del params, frames
        torch.cuda.empty_cache()
        print(f"phase 14: (d) {arch} {dname} done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launched


# -- phase 15: the SPMD layer, flash decode and the "dots" remat policy ---------

P15_ARCH = "internlm2-1.8b"
#: (a) batch, cache slots (decode_32k's length, past the flash-decode
#: threshold), decode steps
P15_DECODE = (8, 32768, 32)
#: (b) batch, sequence, train steps per remat policy
P15_TRAIN = (4, 2048, 3)
#: (c) the dry run's cells on the fake 256-rank world: (arch, shape,
#: extra_cfg); llama4-maverick cut to its first period (4 layers, 2 MoE)
P15_CELLS = (("internlm2-1.8b", "decode_32k", None),
             ("mamba2-370m", "train_4k", None),
             ("llama4-maverick-400b-a17b", "train_4k", {"num_layers": 4}))
#: all-to-alls over "model" per MoE layer and microbatch in a train step:
#: two in the forward, two in its checkpointed recompute, two backward
P15_EXCHANGES = 6
#: calls timed for the custom-op overhead, and the shapes (launch-bound)
P15_OP_CALLS = 2000


def p15_flash_decode(torch, np, T, L, get_config, counters, fa, card):
    """(a) internlm2-1.8b, bf16, full width and depth: a prompt of
    32768 - 32 tokens prefilled into a 32768-slot cache, then 32 decode
    steps with flash decode off, and again from a fresh prefill with it on,
    fed the first run's greedy tokens; tokens/s of each, and the logits of
    the two routes held to each other at phase 7's gated steps within its
    bf16 limit (the rest printed as drift).  Returns flash launches."""
    import dataclasses
    dev = torch.device("cuda")
    B, Lc, steps = P15_DECODE
    cfg = dataclasses.replace(get_config(P15_ARCH), param_dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    prompt = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (B, Lc - steps), dtype=np.int32)).to(dev)
    positions, limit = DECODE_CHECKS["bfloat16"]
    feed, logits, launched = None, {}, 0
    for route in ("sdpa", "flash_decode"):
        L.FLASH_DECODE_ENABLED = route == "flash_decode"
        try:
            for reset, _ in counters:
                reset()
            with torch.inference_mode():
                lg, cache = T.prefill(cfg, params, prompt, cache_len=Lc)
                launched += fa.LAUNCHES["flash_attention"]
                tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
                toks, kept = [], []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(steps):
                    cur = tok if feed is None else feed[i]
                    toks.append(cur)
                    lg, cache = T.decode_step(cfg, params, cache, cur,
                                              Lc - steps + i)
                    kept.append(lg)
                    tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
                torch.cuda.synchronize()
                decode_s = time.perf_counter() - t0
        finally:
            L.FLASH_DECODE_ENABLED = False
        feed = toks if feed is None else feed
        logits[route] = kept
        print(f"phase 15: (a) {P15_ARCH} bf16 batch={B} cache={Lc} {route}: "
              f"{steps} decode steps in {decode_s:.4f} s, "
              f"decode_tokens_per_s={B * steps / decode_s:.1f} on {card}",
              flush=True)
        del cache
        torch.cuda.empty_cache()
    for i in range(steps):
        want = logits["sdpa"][i][:, :cfg.vocab_size].float()
        got = logits["flash_decode"][i][:, :cfg.vocab_size].float()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        gated = i in positions
        if gated or i == steps - 1:
            print(f"phase 15: (a) decode step {i} flash_decode vs sdpa: "
                  f"max_abs_err={err:.4e} (logits max-abs {scale:.4e}; "
                  + (f"limit {limit} of it)" if gated else
                     "drift, not a check)"), flush=True)
        if gated and not (math.isfinite(err) and err <= limit * scale):
            raise AssertionError(f"flash decode step {i}: logits differ "
                                 f"from sdpa by {err}")
    del params, logits
    torch.cuda.empty_cache()
    return launched


def p15_remat(torch, np, get_config, counters, fa, card):
    """(b) internlm2-1.8b, bf16, batch 4 × 2048: train steps from the same
    seeded state under ``remat_policy`` "full" and "dots"; step seconds and
    peak memory of each, the first step's loss equal across the two, and
    flash launches per step equal to phase 12's count.  Returns the
    launches."""
    import dataclasses

    from repro_torch.launch import steps as S
    dev = torch.device("cuda")
    B, Sq, n = P15_TRAIN
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(0, get_config(P15_ARCH).vocab_size,
                                         (B, Sq), dtype=np.int32)).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    first, launched = {}, 0
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(get_config(P15_ARCH),
                                  param_dtype="bfloat16",
                                  remat_policy=policy)
        opt = S.make_optimizer(cfg, total_steps=n)
        state = S.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
        step = S.make_train_step(cfg, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for reset, _ in counters:
            reset()
        times, losses = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        per_step = fa.LAUNCHES["flash_attention"] / n
        launched += fa.LAUNCHES["flash_attention"]
        first[policy] = losses[0]
        print(f"phase 15: (b) {P15_ARCH} bf16 B={B} S={Sq} remat_policy="
              f"{policy}: losses {[round(v, 6) for v in losses]}; step_s "
              f"after the first {sum(times[1:]) / (n - 1):.4f} (first "
              f"{times[0]:.4f}); max_memory_allocated={peak} B; flash "
              f"launches per step {per_step} on {card}", flush=True)
        if per_step != P12_LAUNCHES[P15_ARCH]["launches"]:
            raise AssertionError(f"remat {policy}: {per_step} flash launches "
                                 "a step, phase 12 counts "
                                 f"{P12_LAUNCHES[P15_ARCH]['launches']}")
        del state, step, opt
        torch.cuda.empty_cache()
    if first["full"] != first["dots"]:
        raise AssertionError(f"the first step's loss differs: {first}")
    return launched


def p15_dry_run(card):
    """(c) ``analyze_cell`` on the fake 256-rank world for the cells of
    :data:`P15_CELLS` (the MoE exchange counted), and ``advise`` with its
    default scorer; prints each record's terms and trace seconds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import sharding_advisor
    from repro_torch.launch import dryrun
    for arch, shape, extra in P15_CELLS:
        rec = dryrun.analyze_cell(arch, shape, extra_cfg=extra,
                                  verbose=False)
        coll = {k: int(v["count"]) for k, v in rec["collectives"].items()}
        print(f"phase 15: (c) dry run {arch} {shape} {extra or ''} on "
              f"{rec['mesh']}: flops/device={rec['flops_per_device']:.4e} "
              f"bytes/device={rec['bytes_per_device']:.4e} collective "
              f"bytes/device={rec['collective_bytes_per_device']:.4e} "
              f"compute_s={rec['compute_s']:.4e} memory_s="
              f"{rec['memory_s']:.4e} collective_s={rec['collective_s']:.4e} "
              f"(nvlink {rec['collective_nvlink_s']:.4e}, network "
              f"{rec['collective_network_s']:.4e}) bottleneck="
              f"{rec['bottleneck']} collectives={coll} kernel_calls="
              f"{rec['kernel_calls']} temp_bytes="
              f"{rec['memory_analysis']['temp_bytes']} trace_s="
              f"{rec['compile_s']}", flush=True)
        if extra:
            cfg = dataclasses.replace(get_config(arch), **extra)
            moe = sum(s.ffn == "moe" for s in cfg.all_specs)
            want = P15_EXCHANGES * moe * cfg.accum_steps
            got = rec["collective_ops"].get("all_to_all_single", 0)
            if got != want:
                raise AssertionError(f"{arch}: {got} expert exchanges "
                                     f"(all_to_all_single), {want} expected")
    t0 = time.perf_counter()
    dec = sharding_advisor.advise(P15_ARCH, "decode_32k")
    if len(dec.trail) != 3 or any("error" in t for t in dec.trail):
        raise AssertionError(f"advise: a candidate failed: {dec.trail}")
    print(f"phase 15: (c) advise({P15_ARCH}, decode_32k) with the default "
          f"scorer: winner {dec.winner.name}, dominant term "
          f"{dec.dominant_term_s:.4e} s; trail "
          + "; ".join(f"{t['candidate']} {t['bottleneck']} "
                      f"{sharding_advisor.dominant_term(t):.4e} s"
                      for t in dec.trail)
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def p15_one_rank(torch, np, T, get_config, counters, fa, p7_ids, card):
    """(d) a one-rank NCCL world and a real (1, 1) ``DeviceMesh`` on the
    card: internlm2-1.8b's bf16 parameters (phase 7's seed) distributed by
    the rules, ``serve_batch`` at phase 7's shape; its greedy ids must
    equal phase 7's and its prefill must launch flash once per layer.
    Then ``analyze_cell`` for the same prefill on a one-rank fake mesh,
    its dominant term beside the measured ``prefill_s``.  Returns the
    flash launches."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, serve, shardings
    from repro_torch.launch.mesh import fake_world, make_mesh
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(P15_ARCH), param_dtype="bfloat16")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), dtype=np.int32)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        dparams = shardings.distribute(
            mesh, params, shardings.param_pspecs(cfg, params, mesh))
        del params
        for reset, _ in counters:
            reset()
        out, stats = serve.serve_batch(cfg, dparams, prompts, GEN,
                                       device=dev)
        launched = fa.LAUNCHES["flash_attention"]
        del dparams
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    same = p7_ids is not None and np.array_equal(out, p7_ids)
    print(f"phase 15: (d) {P15_ARCH} bf16 serve_batch on a one-rank NCCL "
          f"(1, 1) DeviceMesh, DTensor parameters: batch={SERVE_BATCH} "
          f"prompt={PROMPT_LEN} gen={GEN}: prefill_s="
          f"{stats['prefill_s']:.4f} decode_tokens_per_s="
          f"{stats['tokens_per_s']:.1f}; greedy ids equal phase 7's: {same}; "
          f"flash launches {launched} on {card}", flush=True)
    if not same:
        raise AssertionError("DTensor serve_batch ids differ from phase 7's")
    if launched != cfg.num_layers:
        raise AssertionError(f"DTensor prefill launched flash {launched} "
                             f"times, not once per layer ({cfg.num_layers})")
    shape = ShapeSpec(f"prefill_{PROMPT_LEN}", PROMPT_LEN, SERVE_BATCH,
                      "prefill")
    with fake_world(1):
        rec = dryrun.analyze_cell(P15_ARCH, shape, mesh=make_mesh(
            (1, 1), ("data", "model")), verbose=False)
    terms = {k: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    print(f"phase 15: (d) dry run of that prefill on a one-rank fake mesh: "
          f"{terms}, dominant {rec['bottleneck']} "
          f"{max(terms.values()):.4f} s against the measured prefill_s "
          f"{stats['prefill_s']:.4f} s (flops {rec['flops_per_device']:.4e}, "
          f"bytes {rec['bytes_per_device']:.4e}, trace_s "
          f"{rec['compile_s']}) on {card}", flush=True)
    return launched


def p15_op_overhead(torch, fa, ss, card):
    """The kernels' custom ops against their bare launchers at launch-bound
    shapes: host microseconds a call over :data:`P15_OP_CALLS` calls."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ss_ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn((1, 1, 128, 64), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    x = torch.randn((1, 64, 2, 16), generator=g, device=dev)
    dt = torch.rand((1, 64, 2), generator=g, device=dev) * 0.1
    A = -torch.rand((2,), generator=g, device=dev)
    Bm = torch.randn((1, 64, 16), generator=g, device=dev)
    pairs = {
        "flash_attention": (
            lambda: fa.flash_attention(q, k, v, causal=True),
            lambda: fa_ops.flash_attention_op(q, k, v, True, None, 0.0,
                                              None)),
        "ssd_scan": (lambda: ss.ssd_scan(x, dt, A, Bm, Bm, 64),
                     lambda: ss_ops.ssd_scan_op(x, dt, A, Bm, Bm, 64))}
    rows = {}
    for name, (bare, op) in pairs.items():
        us = {}
        for _ in range(2):                      # bare, op, bare, op
            for what, fn in (("bare", bare), ("op", op)):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(P15_OP_CALLS):
                    fn()
                torch.cuda.synchronize()
                us.setdefault(what, []).append(
                    (time.perf_counter() - t0) / P15_OP_CALLS * 1e6)
        rows[name] = {w: min(v) for w, v in us.items()}
        print(f"phase 15: custom-op overhead {name}: bare launcher "
              f"{rows[name]['bare']:.2f} us a call, custom op "
              f"{rows[name]['op']:.2f} us a call (+"
              f"{rows[name]['op'] - rows[name]['bare']:.2f} us), best of 2 "
              f"runs of {P15_OP_CALLS} calls, host clock, on {card}",
              flush=True)
    return rows


# -- phase 16: a stored dataset on a mesh of several positions ----------------

#: the steps of phase 16 that repartition SF-10 lineitem onto a mesh: (a) 4
#: positions on ("data",), (b) (2, 2) on ("data", "model"), (c) the visible
#: cards, (d) ``apply_decision(mesh=)`` onto (a)'s mesh
P16_STEPS = ("4", "2x2", "cards", "apply")
#: the hash kernels' exact launches in (a), (b) and (d), predicted by a CPU
#: dry run with the shuffles in the card's fused mode
#: (``tests/test_torch_mesh_store.py``): one hash of each source block's
#: rows, one ``scatter_perm`` ordering them by pid (none where there is one
#: destination block) and one ``scatter_perm`` scattering each destination
#: block; (c) depends on the cards (:func:`p16_card_launches`)
P16_LAUNCHES = {
    "4": {"hash_partition": 4, "hash_partition_padded": 0,
          "scatter_perm": 8},
    "2x2": {"hash_partition": 2, "hash_partition_padded": 0,
            "scatter_perm": 4},
    "apply": {"hash_partition": 4, "hash_partition_padded": 0,
              "scatter_perm": 8},
}


def p16_extent(cards: int) -> int:
    """The largest divisor of M no larger than ``cards``."""
    return max(e for e in range(1, max(cards, 1) + 1) if M % e == 0)


def p16_card_launches(cards: int) -> dict:
    e = p16_extent(cards)
    return {"hash_partition": e, "hash_partition_padded": 0,
            "scatter_perm": 2 * e if e > 1 else 1}


def p16_check_shards(np, ds, mesh, want, what):
    """Every shard of every column bit-equal to the matching block of the
    host layout ``want``, placed ``P("data", None, ...)`` on ``mesh``."""
    from repro_torch.core.sharding_bridge import (ShardedColumn,
                                                  sharding_for, sharding_of)
    if not np.array_equal(ds.counts, want["counts"]):
        raise AssertionError(f"{what}: counts differ from the host backend's")
    extent = mesh.shape["data"]
    for k, col in ds.columns.items():
        if not isinstance(col, ShardedColumn) or sharding_of(ds, k) != \
                sharding_for(mesh, ds.partitioner, extra_dims=col.dim() - 2):
            raise AssertionError(f"{what}: column {k} placed as "
                                 f"{sharding_of(ds, k)}")
        ref = want["columns"][k]
        shards = list(col.shards())
        if len(shards) != mesh.devices.size or \
                {(s.start, s.stop) for _, _, s, _ in shards} != {
                    (j * M // extent, (j + 1) * M // extent)
                    for j in range(extent)}:
            raise AssertionError(f"{what}: column {k} has shards "
                                 f"{[s for _, _, s, _ in shards]}")
        for idx, dev, sl, t in shards:
            if dev != mesh.devices[idx] or t.device != dev:
                raise AssertionError(f"{what}: column {k} shard {idx} is "
                                     f"on {t.device}, not {dev}")
            got = t.cpu().numpy()
            if got.dtype != ref.dtype or got.shape != ref[sl].shape \
                    or not np.array_equal(got, ref[sl]):
                raise AssertionError(f"{what}: column {k} shard {idx} "
                                     "differs from the host backend's")


def p16_step_times(torch, np, tdr, placed, cand, mesh, device):
    """A second, direct ``sharded_repartition_dataset`` of ``placed``:
    (host seconds, {step: (CUDA-event seconds, the slowest device's; host
    seconds issuing it)}, the rows and bytes that crossed shards, reckoned
    from the histograms, and on the card a third call traced by
    torch.profiler: (device-busy ms, wall ms, {kernel: ms}))."""
    devs = list(dict.fromkeys(mesh.devices.flat))
    marks = []

    def mark(name, info):
        evs = {}
        if device == "cuda":
            for d in devs:
                with torch.cuda.device(d):
                    evs[d] = torch.cuda.Event(enable_timing=True)
                    evs[d].record()
        marks.append((name, evs, info, time.perf_counter()))

    def sync():
        if device == "cuda":
            for d in devs:
                torch.cuda.synchronize(d)

    sync()
    t0 = time.perf_counter()
    mark("start", {})
    out = tdr.sharded_repartition_dataset(placed, cand, M, mesh,
                                          on_step=mark)
    sync()
    wall = time.perf_counter() - t0
    steps = {}
    for (_, ea, _, ha), (b, eb, _, hb) in zip(marks, marks[1:]):
        steps[b] = (max(ea[d].elapsed_time(eb[d]) for d in devs) / 1e3
                    if device == "cuda" else None, hb - ha)
    hist = next(info["histograms"] for n, _, info, _ in marks
                if n == "sources")
    n_src, n_dst = hist.shape[0], mesh.shape["data"]
    w = M // n_dst
    stay = sum(int(hist[s, s * w:(s + 1) * w].sum())
               for s in range(min(n_src, n_dst))) if n_src == n_dst else 0
    crossed = int(hist.sum()) - stay
    row = sum(v.element_size() * int(np.prod(v.shape[2:]))
              for v in placed.columns.values())
    del out
    traced = None
    if device == "cuda":
        _, busy, twall, by_name = device_busy(
            torch, lambda: tdr.sharded_repartition_dataset(placed, cand, M,
                                                           mesh)[1])
        traced = (busy, twall, by_name)
    return wall, steps, crossed, crossed * row, traced


def p16_mesh(torch, np, lt, tcore, lineitem, want, tables, card, reset,
             read, device="cuda", steps=P16_STEPS):
    """Phase 4's SF-10 lineitem written by orderkey and placed on meshes of
    several positions, repartitioned to partkey shard to shard: (a) 4
    positions over the card, (b) (2, 2) ("data", "model"), (c) the visible
    cards (the largest divisor of M not above their count), (d)
    ``apply_decision(mesh=)`` onto (a)'s mesh from a placed generation;
    every shard bit-equal to ``want`` (phase 4's host layout), no column
    read whole, the hash kernels' launches (``reset``/``read``) equal to
    :data:`P16_LAUNCHES`.  Then (d) q04-like over ``tables`` (orders and
    lineitem) with lineitem placed on (a)'s mesh by
    ``apply_decision(mesh=)``, equal to the host backend's.  Returns the
    launches per step.  ``device="cpu"`` is the CPU dry run
    (``tests/test_torch_mesh_store.py``), with fused-mode counts."""
    from repro_torch.core import sharding_bridge as sb
    from repro_torch.core.executor import TableVal
    from repro_torch.data import device_repartition as tdr
    dev = torch.device(device)
    if device == "cuda":
        cards = torch.cuda.device_count()
        card_devs = [torch.device("cuda", i) for i in range(cards)]
    else:
        cards, card_devs = 1, [dev]
    extent = p16_extent(cards)
    meshes = {"4": sb.Mesh([dev] * 4, ("data",)),
              "2x2": sb.Mesh([[dev] * 2] * 2, ("data", "model")),
              "cards": sb.Mesh(card_devs[:extent], ("data",))}
    meshes["apply"] = meshes["4"]
    expect = dict(P16_LAUNCHES, cards=p16_card_launches(cards))
    print(f"phase 16: {cards} visible card(s), mesh (c) over {extent} of "
          f"them (the largest divisor of m = {M}); {card}", flush=True)
    wl = lt.Workload("sf10")
    li = wl.scan("lineitem")
    wl.partition(li["orderkey"])
    wl.partition(li["partkey"])
    by_order, by_part = tcore.enumerate_candidates(wl.graph, "lineitem")
    sess = lt.Session(num_workers=M, device=device)
    written = sess.write("lineitem", lineitem, by_order)
    launches = {}

    def timed(step, fn):
        mesh = meshes[step]
        sess.store.synchronize()
        if device == "cuda":
            for d in set(mesh.devices.flat):
                torch.cuda.synchronize(d)
        sb.reset_whole_reads()
        reset()
        t0 = time.perf_counter()
        new, moved = fn(mesh)
        sess.store.synchronize()
        wall = time.perf_counter() - t0
        launches[step] = read()
        reads = sb.WHOLE_READS["columns"]
        what = f"phase 16 ({step})"
        if sess.store.read(new.name) is not new:
            raise AssertionError(f"{what}: the store does not serve the "
                                 "placed generation")
        if sess.store.write_log[-1].get("path") != "d2d":
            raise AssertionError(f"{what}: the repartition did not run d2d")
        if reads:
            raise AssertionError(f"{what}: {reads} columns read whole on "
                                 "one device")
        if launches[step] != expect[step]:
            raise AssertionError(f"{what}: hash-kernel launches "
                                 f"{launches[step]}, the dry run gives "
                                 f"{expect[step]}")
        p16_check_shards(np, new, mesh, want, what)
        print(f"{what}: lineitem ({len(lineitem['orderkey'])} rows) "
              f"repartitioned shard to shard on {mesh}: wall {wall:.4f} s "
              f"after a synchronize, moved_bytes={moved}, every shard "
              f"bit-equal to phase 4's host layout, no column read whole, "
              f"launches {launches[step]} on {card}", flush=True)
        return new

    for step in [s for s in steps if s != "apply"]:
        mesh = meshes[step]
        placed = sb.device_put_dataset(mesh, written)
        new = timed(step, lambda mesh: sess.store.repartition(
            placed, by_part, name=f"lineitem@{step}", mesh=mesh))
        del new
        wall, times, crossed, crossed_b, traced = p16_step_times(
            torch, np, tdr, placed, by_part, mesh, device)
        fmt = ", ".join(
            f"{k} {'not measured' if ev is None else f'{ev:.6f} s'} "
            f"(host {h:.6f} s)" for k, (ev, h) in times.items())
        print(f"phase 16 ({step}): a direct sharded_repartition_dataset "
              f"{wall:.4f} s host; CUDA events per step (host seconds "
              f"issuing it): {fmt}; crossed shards: {crossed} rows, "
              f"{crossed_b} bytes (from the histograms) on {card}",
              flush=True)
        if traced is not None:
            busy, twall, by_name = traced
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            n_dev = len(set(mesh.devices.flat))
            idle = (f"idle {1 - busy / twall:.1%}" if n_dev == 1 else
                    f"summed over {n_dev} cards")
            print(f"phase 16 ({step}): traced: device busy {busy:.3f} of "
                  f"{twall:.1f} ms wall ({idle}); top kernels "
                  + ", ".join(f"{k[:48]} {v:.3f} ms" for k, v in top),
                  flush=True)
        del placed
    if "apply" in steps:
        # lineitem's current generation placed on the mesh, by orderkey
        sess.repartition("lineitem", by_order, mesh=meshes["apply"])
        dec = tcore.PartitioningDecision(
            dataset="lineitem", candidate=by_part, features=[], consumers=[],
            action_index=0, state=None, elapsed_s=0.0)
        timed("apply", lambda mesh: tcore.apply_decision(sess.store, dec,
                                                         mesh=mesh))
        p16_consumer(torch, np, lt, tcore, TableVal, tables, meshes["4"],
                     card, device)
    del sess, written
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches}


def p16_consumer(torch, np, lt, tcore, TableVal, tables, mesh, card,
                 device):
    """Phase 3's q04-like over orders and lineitem, lineitem placed on
    ``mesh`` by ``apply_decision(mesh=)`` (by orderkey): verdicts and every
    node's columns equal to the host backend's after the same decision."""
    from repro_torch.core.sharding_bridge import sharding_for, sharding_of
    orders, lineitem = tables[0], tables[1]
    build = tpch_queries(lt.Workload)["q04"][0]
    res = {}
    for backend in ("device", "host"):
        wl = build()
        kw = {"device": device} if backend == "device" else {}
        sess = lt.Session(num_workers=M, backend=backend, **kw)
        sess.write("orders", orders,
                   tcore.enumerate_candidates(wl.graph, "orders")[0])
        sess.write("lineitem", lineitem)
        dec = tcore.PartitioningDecision(
            dataset="lineitem",
            candidate=tcore.enumerate_candidates(wl.graph, "lineitem")[0],
            features=[], consumers=[], action_index=0, state=None,
            elapsed_s=0.0)
        placed, _ = tcore.apply_decision(
            sess.store, dec, mesh=mesh if backend == "device" else None)
        if backend == "device" and sharding_of(placed, "orderkey") != \
                sharding_for(mesh, placed.partitioner):
            raise AssertionError("phase 16 (d): lineitem is not placed on "
                                 "the mesh")
        sess.store.synchronize()
        t0 = time.perf_counter()
        res[backend] = sess.run(wl)
        sess.store.synchronize()
        wall = time.perf_counter() - t0
        st = res[backend].stats
        print(f"phase 16 (d): q04-like over lineitem "
              f"({len(lineitem['orderkey'])} rows"
              f"{', placed on ' + str(mesh) if backend == 'device' else ''})"
              f" backend={backend}: wall_s={wall:.4f} "
              f"elided={st.shuffles_elided} "
              f"shuffles={st.shuffles_performed}", flush=True)
    d, h = res["device"], res["host"]
    if (d.stats.shuffles_elided, d.stats.shuffles_performed) != \
            (h.stats.shuffles_elided, h.stats.shuffles_performed) \
            or d.stats.shuffles_elided != 2:
        raise AssertionError("phase 16 (d): verdicts differ, or a join "
                             "shuffle was not elided")
    for nid, hv in h.values.items():
        if not isinstance(hv, TableVal):
            continue
        dv = d.values[nid]
        if not np.array_equal(dv.counts, hv.counts):
            raise AssertionError(f"phase 16 (d): node {nid} counts differ")
        for k, col in hv.columns.items():
            got = dv.columns[k]
            if got.dtype != col.dtype or not np.array_equal(got, col):
                raise AssertionError(f"phase 16 (d): node {nid} column {k} "
                                     "differs from the host backend's")
            if col.dtype.kind == "f" and not np.isfinite(col).all():
                raise AssertionError(f"phase 16 (d): non-finite {k}")
    print(f"phase 16 (d): q04-like over the placed lineitem equal to the "
          f"host backend on every node, both join shuffles elided, on "
          f"{card}", flush=True)


# -- phase 17: training the seven configs one card holds -----------------------

#: (b): (arch, decoder layers, batch, sequence); full width, bf16 as the
#: configs say, remat on, ``accum_steps=1`` (one or two rows a batch, eight
#: for whisper); the depth cut (an encoder cut alike) so that
#: :func:`p17_reckon` stays under :data:`P17_BYTES_LIMIT`; whisper-small
#: first ((c) restarts it), the last one's ``train`` beside (d)
P17_LM = (("whisper-small", 12, 8, 224),
          ("recurrentgemma-9b", 12, 2, 2048),
          ("gemma-7b", 8, 2, 2048),
          ("gemma2-27b", 4, 2, 2048),
          ("qwen1.5-110b", 2, 1, 2048),
          ("chameleon-34b", 4, 2, 2048),
          ("deepseek-v2-236b", 2, 1, 2048))
#: (b) train steps on one repeated batch, the first a warm-up
P17_STEPS = 4
#: (b) steps of ``train`` itself over ``TokenSource``'s batches before its
#: checkpoint
P17_TRAIN_STEPS = 2
#: (a) batch and sequence of the float32 check at one pattern period
P17_CHECK = (1, 128)
#: (a) the card's float32 loss against the CPU port's (relative), and each
#: gradient leaf's error norm over the CPU leaf's norm: the limit of
#: ``tests/test_torch_cuda.py``'s train-forward case (GEMMs and reductions
#: sum in other orders; the kernel's forward is within 3e-5 of the twin)
P17_LOSS_TOL, P17_GRAD_TOL = 1e-4, 1e-3
#: what a step may reckon to hold on one 80 GB card
P17_BYTES_LIMIT = 70e9
#: (c) whisper-small's restart: steps, checkpoint every, failure at
P17_RESTART = (4, 2, 3)
P17_SEED = 17
#: flash launches and backward recomputes of one loss/backward, (a) at one
#: pattern period and (b) at :data:`P17_LM`'s depth, predicted by a CPU dry
#: run of the same calls at the same depths with the kernels' Functions on
#: CPU stand-ins (``tests/test_torch_train.py``): under remat each attention
#: (whisper: encoder, self and cross) runs forward twice and back once
P17_LAUNCHES = {
    "whisper-small": {"check": {"launches": 6, "recomputes": 3},
                      "step": {"launches": 72, "recomputes": 36}},
    "recurrentgemma-9b": {"check": {"launches": 2, "recomputes": 1},
                          "step": {"launches": 8, "recomputes": 4}},
    "deepseek-v2-236b": {"check": {"launches": 4, "recomputes": 2},
                         "step": {"launches": 4, "recomputes": 2}},
    "gemma-7b": {"check": {"launches": 2, "recomputes": 1},
                 "step": {"launches": 16, "recomputes": 8}},
    "gemma2-27b": {"check": {"launches": 4, "recomputes": 2},
                   "step": {"launches": 8, "recomputes": 4}},
    "qwen1.5-110b": {"check": {"launches": 2, "recomputes": 1},
                     "step": {"launches": 4, "recomputes": 2}},
    "chameleon-34b": {"check": {"launches": 2, "recomputes": 1},
                      "step": {"launches": 8, "recomputes": 4}},
}
#: (d) ``examples/torch/<name>.py``, run on the card as they stand
P17_EXAMPLES = ("quickstart", "autopilot_drift", "serve_batch", "train_lm",
                "elastic_restart", "reddit_integration")
P17_EXAMPLE_TIMEOUT_S = 300


def p17_config(base, layers, dtype=None):
    """``base`` with ``layers`` decoder layers and an encoder (whisper's:
    as deep as its decoder) of as many, ``accum_steps=1``, in ``dtype``
    where given."""
    import dataclasses
    kw = {"num_layers": layers, "accum_steps": 1}
    if base.encoder is not None:
        kw["encoder"] = dataclasses.replace(base.encoder, num_layers=layers)
    if dtype is not None:
        kw["param_dtype"] = dtype
    return dataclasses.replace(base, **kw)


def p17_period(cfg) -> int:
    """Layers in one pattern period, the prefix included."""
    return len(cfg.prefix) + len(cfg.pattern)


def p17_reckon(torch, cfg, batch, seq, optimizer=True):
    """The bytes one loss/backward (``optimizer``: and a donated AdamW
    update, then a checkpoint) holds at its peak, reckoned from the
    parameter shapes on the meta device before anything is allocated: the
    weights and gradients of every parameter and, with the optimizer, its
    two moments; the update's float32 temporaries (about 6 × 4 B an
    element of the largest leaf, updated in slices of ``DONATE_CHUNK``);
    the float32 logits and their gradient, B·S·V·8 B; the twin's float32
    scores in ``KernelAttention.backward``, about 4 × B·H·Sq·Skv·4 B at the
    model's largest attention (self, encoder or cross).  A checkpoint
    holds the weights and moments (``checkpoint``, the bytes it writes)
    and ``stack_state``'s copy of the pattern layers' and the encoder's
    (``stacked_copy``), the gradients freed: ``total`` is the larger of
    the two peaks."""
    from repro_torch import tree
    from repro_torch.models import transformer as T
    from repro_torch.optimizer.adamw import DONATE_CHUNK
    params = T.init_params(cfg, torch.Generator(), "meta")
    leaves = tree.leaves(params)
    n = sum(t.numel() for t in leaves)
    big = max(t.numel() for t in leaves)
    moment = 2 if cfg.opt_state_bf16 else None

    def held(ts):                           # weights and two moments
        return sum(t.numel() * (t.element_size()
                                + 2 * (moment or t.element_size()))
                   for t in ts)

    weights = sum(t.numel() * t.element_size() for t in leaves)
    state, update, checkpoint, copy = 2 * weights, 0, 0, 0
    if optimizer:
        checkpoint = held(leaves)
        state += checkpoint - weights
        update = 6 * 4 * min(big, DONATE_CHUNK)
        n_pre = len(cfg.prefix)
        copy = held(tree.leaves(
            params["layers"][n_pre:n_pre + cfg.pattern_groups
                             * len(cfg.pattern)])
            + tree.leaves(params.get("encoder", {}).get("layers", [])))
    pairs = [seq * seq]
    if cfg.encoder is not None:
        F = cfg.encoder.num_frames
        pairs += [F * F, seq * F]
    scores = 4 * batch * cfg.num_heads * max(pairs) * 4
    logits = batch * seq * cfg.vocab_size * 8
    step = state + update + logits + scores
    return {"params": n, "largest_leaf": big, "state": state,
            "update": update, "logits": logits, "scores": scores,
            "step": step, "checkpoint": checkpoint, "stacked_copy": copy,
            "total": max(step, checkpoint + copy)}


def p17_print_reckoning(label, rk):
    gb = 1e9
    line = (f"{label}: reckoned before the call: {rk['params']} parameters; "
            f"weights, gradients{' and moments' if rk['update'] else ''} "
            f"{rk['state'] / gb:.2f} GB")
    if rk["update"]:
        line += (f", the update's float32 temporaries "
                 f"{rk['update'] / gb:.2f} GB (largest leaf "
                 f"{rk['largest_leaf']})")
    line += (f", float32 logits and their gradient {rk['logits'] / gb:.2f} "
             f"GB, the twin's float32 scores {rk['scores'] / gb:.2f} GB: a "
             f"step {rk['step'] / gb:.2f} GB")
    if rk["checkpoint"]:
        line += (f"; a checkpoint: weights and moments "
                 f"{rk['checkpoint'] / gb:.2f} GB and stack_state's copy "
                 f"{rk['stacked_copy'] / gb:.2f} GB")
    print(line + f"; total {rk['total'] / gb:.2f} GB (limit "
          f"{P17_BYTES_LIMIT / gb:.0f} GB)", flush=True)


def p17_batch(np, torch, cfg, batch, seq, device):
    """Seeded tokens, next-token labels and, for an encoder config, frames
    (B, F, D) in the config's dtype."""
    from repro_torch.models.transformer import dtype_of
    rng = np.random.default_rng(P17_SEED)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    out = {"tokens": torch.from_numpy(tokens).to(device),
           "labels": torch.from_numpy(np.roll(tokens, -1, 1)).to(device)}
    if cfg.encoder is not None:
        frames = rng.standard_normal(
            (batch, cfg.encoder.num_frames, cfg.d_model), dtype=np.float32)
        out["frames"] = torch.from_numpy(frames * 0.5).to(
            device=device, dtype=dtype_of(cfg))
    return out


def p17_kernel_only(grads):
    """{name: smallest norm} of the gradients that reach the loss only
    through the flash kernel: ``wq`` (self, cross and encoder attention)
    and MLA's ``wq_b`` and ``wkv_b``; RG-LRU layers have none."""
    out = {}
    layers = list(grads["layers"]) + list(
        grads.get("encoder", {}).get("layers", []))
    for layer in layers:
        for block in ("attn", "cross"):
            for k in ("wq", "wq_b", "wkv_b"):
                leaf = layer.get(block, {}).get(k)
                if leaf is not None:
                    norm = float(leaf["w"].float().norm())
                    name = f"{block}.{k}"
                    out[name] = min(out.get(name, norm), norm)
    return out


def p17_label(part, arch, cfg, batch, seq) -> str:
    enc = (f" + {cfg.encoder.num_layers} encoder"
           if cfg.encoder is not None else "")
    return (f"phase 17: {part} {arch} {cfg.param_dtype}, {cfg.num_layers}"
            f"{enc} layers, B={batch} S={seq}")


def p17_check(env, base, arch):
    """(a) one float32 ``value_and_grad`` at full width and one pattern
    period of depth on ``env.device`` (the float32 kernel, the twin's VJP
    backward), then on the CPU port from the same weights and batch (the
    plain twins): the loss within P17_LOSS_TOL, every leaf within
    P17_GRAD_TOL, the kernel-only leaves nonzero, the launches
    P17_LAUNCHES[arch]["check"]."""
    torch, np = env.torch, env.np
    from repro_torch import tree
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    cfg = p17_config(base, p17_period(base), "float32")
    B, Sq = P17_CHECK
    what = p17_label("(a)", arch, cfg, B, Sq)
    rk = p17_reckon(torch, cfg, B, Sq, optimizer=False)
    p17_print_reckoning(what, rk)
    if rk["total"] > P17_BYTES_LIMIT:
        raise AssertionError(f"{what}: reckoned {rk['total']} B")
    dev = env.device
    walls = {}
    t0 = time.perf_counter()
    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(P17_SEED), dev)
    batch = p17_batch(np, torch, cfg, B, Sq, dev)
    env.sync()
    walls["init"] = time.perf_counter() - t0
    env.reset()
    t0 = time.perf_counter()
    loss, _, grads = S.value_and_grad(cfg, params, batch)
    env.sync()
    walls["device"] = time.perf_counter() - t0
    counts = env.read("flash_attention")
    t0 = time.perf_counter()
    host = tree.map(lambda t: t.cpu(), params)
    del params
    walls["to_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    closs, _, cgrads = S.value_and_grad(
        cfg, host, {k: v.cpu() for k, v in batch.items()})
    walls["cpu"] = time.perf_counter() - t0
    del host
    t0 = time.perf_counter()
    loss_rel = abs(float(loss) - float(closs)) / max(abs(float(closs)),
                                                     1e-30)
    worst, worst_at, n_leaves = 0.0, None, 0
    for (path, g), c in zip(tree.flatten_with_paths(grads),
                            tree.leaves(cgrads)):
        c = c.to(g.device)                  # compared where g lies
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: gradient {tree.path_str(path)} "
                                 "not finite")
        rel = float((g - c).norm() / c.norm().clamp_min(1e-30))
        if rel > worst or worst_at is None:
            worst, worst_at = rel, tree.path_str(path)
        n_leaves += 1
    only = p17_kernel_only(grads)
    del grads, cgrads
    walls["compare"] = time.perf_counter() - t0
    print(f"{what}: loss {float(loss):.6f} on {env.card} vs {float(closs):.6f}"
          f" on the CPU (rel {loss_rel:.3e}, limit {P17_LOSS_TOL}); "
          f"{n_leaves} gradient leaves, largest error norm / norm {worst:.3e}"
          f" at {worst_at} (limit {P17_GRAD_TOL}); reaching the loss only "
          f"through flash_attention (smallest norm): "
          + ", ".join(f"{k} {v:.4e}" for k, v in only.items())
          + f"; flash launches {counts['launches']}, backward recomputes "
          f"{counts['recomputes']}; seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()), flush=True)
    if not loss_rel <= P17_LOSS_TOL or not worst <= P17_GRAD_TOL:
        raise AssertionError(f"{what}: the card's loss or gradients differ "
                             f"from the CPU port's: loss rel {loss_rel}, "
                             f"{worst_at} {worst}")
    if not only or min(only.values()) <= 0:
        raise AssertionError(f"{what}: a gradient reaching the loss only "
                             f"through flash_attention is zero: {only}")
    if counts != P17_LAUNCHES[arch]["check"]:
        raise AssertionError(f"{what}: counted {counts}, the dry run "
                             f"predicts {P17_LAUNCHES[arch]['check']}")
    return {"loss_rel": loss_rel, "grad_rel": worst, "counts": counts,
            "kernel_only": only, "reckoned": rk, "walls": walls}


def p17_steps(env, cfg, arch, batch, seq, n_steps=P17_STEPS):
    """(b) ``n_steps`` donated bf16 train steps on one repeated batch: the
    reckoning printed first, the loss finite at every step and lower at
    the last than at the first, launches per step P17_LAUNCHES[arch]
    ["step"]; step seconds (median after a warm-up), tokens/s, peak memory
    against the reckoned step, on the card the share of a step under
    ``KernelAttentionBackward``, and MoE's ``dropped_frac`` from a no-grad
    forward over the batch."""
    torch, np = env.torch, env.np
    from repro_torch import tree
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    dev = env.device
    what = p17_label("(b)", arch, cfg, batch, seq)
    rk = p17_reckon(torch, cfg, batch, seq)
    p17_print_reckoning(what, rk)
    if rk["total"] > P17_BYTES_LIMIT:
        raise AssertionError(f"{what}: reckoned {rk['total']} B")
    opt = S.make_optimizer(cfg, peak_lr=P12_LR, total_steps=n_steps)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    state = S.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(P17_SEED), opt,
        device=dev)
    held = sum(t.numel() for t in tree.leaves(state["params"]))
    if held != rk["params"]:
        raise AssertionError(f"{what}: {held} parameters, reckoned "
                             f"{rk['params']}")
    b0 = p17_batch(np, torch, cfg, batch, seq, dev)
    step = S.make_train_step(cfg, opt, donate=True)
    env.sync()
    walls = {"init": time.perf_counter() - t_init}
    losses, times = [], []
    env.reset()
    for _ in range(n_steps):
        env.sync()
        t0 = time.perf_counter()
        state, met = step(state, b0)
        losses.append(float(met["loss"]))
        env.sync()
        times.append(time.perf_counter() - t0)
    counts = env.read("flash_attention")
    per_step = {k: v / n_steps for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    walls["steps"] = sum(times)
    out = {"losses": losses, "step_s": step_s, "first_step_s": times[0],
           "tokens_per_s": batch * seq / step_s, "peak_bytes": peak,
           "per_step": per_step, "reckoned": rk, "walls": walls}
    print(f"{what}: {n_steps} steps on one batch, loss "
          f"{[round(v, 4) for v in losses]}; step_s after a warm-up step "
          f"{step_s:.4f} (first {times[0]:.4f}, all "
          f"{[round(t, 4) for t in times]}); tokens/s "
          f"{out['tokens_per_s']:.1f}; max_memory_allocated {peak} B "
          f"(reckoned a step {rk['step']} B); flash per step {per_step} on "
          f"{env.card}", flush=True)
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss is not finite or did not "
                             f"fall: {losses}")
    if per_step != P17_LAUNCHES[arch]["step"]:
        raise AssertionError(f"{what}: per step {per_step}, the dry run "
                             f"predicts {P17_LAUNCHES[arch]['step']}")
    t0 = time.perf_counter()
    if dev == "cuda":
        share = p12_recompute_share(torch, lambda: step(state, b0))
        walls["profiled_step"] = time.perf_counter() - t0
        if share is None:
            print(f"{what}: KernelAttention.backward's share not measured "
                  "(no Kernel*Backward node in the trace)", flush=True)
        else:
            out["recompute_ms"], out["step_device_ms"] = share
            print(f"{what}: torch.profiler, one step: device {share[1]:.2f} "
                  f"ms, of which KernelAttention.backward (the twin's "
                  f"float32 recompute and VJP) {share[0]:.2f} ms = "
                  f"{100 * share[0] / share[1]:.1f}% on {env.card}",
                  flush=True)
    if cfg.moe is not None:
        with torch.inference_mode():
            _, _, aux = T.prefill(cfg, state["params"], b0["tokens"],
                                  frames=b0.get("frames"), with_aux=True)
        out["dropped_frac"] = [float(d) for d in aux["dropped_frac"]]
        print(f"{what}: MoE dropped_frac per MoE layer at capacity factor "
              f"{cfg.moe.capacity_factor} (a no-grad forward over the batch)"
              f": {out['dropped_frac']}", flush=True)
    del state
    print(f"{what}: seconds " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in walls.items()),
          flush=True)
    return out


def p17_train(env, cfg, arch, batch, seq, work, checkpoint,
              n_steps=P17_TRAIN_STEPS):
    """(b) the trainer's entry point, ``train(TrainRun(...))``, from a fresh
    state: ``n_steps`` donated steps over ``TokenSource``'s batches and,
    with ``checkpoint``, its final state checkpointed under ``work`` in the
    reference's stacked layout (``stack_state`` on the card; removed
    after).  Every loss finite (random tokens teach nothing to fall to),
    launches per step P17_LAUNCHES[arch]["step"], the checkpoint's bytes
    on disk the reckoned weights and moments; ``train``'s step seconds,
    peak memory against the reckoned total and the seconds outside the
    steps (init and any checkpoint)."""
    import shutil

    torch = env.torch
    from repro_torch.launch import train as TR
    dev = env.device
    what = p17_label("(b) train", arch, cfg, batch, seq)
    rk = p17_reckon(torch, cfg, batch, seq)
    ck = Path(work) / f"ckpt-{arch}"
    run = TR.TrainRun(cfg=cfg, total_steps=n_steps, global_batch=batch,
                      seq_len=seq, ckpt_dir=str(ck) if checkpoint else None,
                      peak_lr=P12_LR, seed=P17_SEED, log_every=n_steps,
                      device=dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    env.reset()
    t0 = time.perf_counter()
    got = TR.train(run)
    env.sync()
    wall = time.perf_counter() - t0
    counts = env.read("flash_attention")
    del got["state"]
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    try:
        on_disk = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    losses, times = got["losses"], got["step_s"]
    per_step = {k: v / n_steps for k, v in counts.items()}
    out = {"losses": losses, "step_s": times, "peak_bytes": peak,
           "checkpoint_bytes": on_disk, "per_step": per_step,
           "outside_steps_s": wall - sum(times), "wall_s": wall}
    saved = (f"the checkpoint {on_disk} B on disk (weights and moments "
             f"reckoned {rk['checkpoint']} B)" if checkpoint else
             "no checkpoint (the step's reckoned peak is above a "
             "checkpoint's)")
    print(f"{what}: train {n_steps} steps over TokenSource's batches, loss "
          f"{[round(v, 4) for v in losses]}, step seconds "
          f"{[round(t, 4) for t in times]}; init and any checkpoint "
          f"{out['outside_steps_s']:.2f} s; {saved}; max_memory_allocated "
          f"{peak} B (reckoned {rk['total']} B); flash per step {per_step} "
          f"on {env.card}", flush=True)
    if len(losses) != n_steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: losses {losses}")
    if per_step != P17_LAUNCHES[arch]["step"]:
        raise AssertionError(f"{what}: per step {per_step}, the dry run "
                             f"predicts {P17_LAUNCHES[arch]['step']}")
    if checkpoint and not \
            rk["checkpoint"] < on_disk < rk["checkpoint"] + (1 << 20):
        raise AssertionError(f"{what}: the checkpoint holds {on_disk} B, "
                             f"reckoned {rk['checkpoint']} B and headers")
    return out


def p17_checkpoints(rk) -> bool:
    """Whether (b)'s ``train`` writes its checkpoint: where the checkpoint
    (the weights and moments with ``stack_state``'s copy) reckons above
    the step, it sets the run's peak; elsewhere the steps do, and the
    checkpoint (at ~1.3 GB/s to disk) is left to (c)."""
    return rk["checkpoint"] + rk["stacked_copy"] > rk["step"]


def p17_examples(card, meanwhile):
    """(d) each ``examples/torch/*.py`` on the card in a process of its own,
    all started together, ``meanwhile()`` run while they run (the walls
    overlap): each must exit 0 within P17_EXAMPLE_TIMEOUT_S.  {name: wall
    seconds}."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)

    def run(name):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py")],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=P17_EXAMPLE_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(P17_EXAMPLES)) as pool:
        runs = pool.map(run, P17_EXAMPLES)      # all submitted at once
        meanwhile()
        done = list(zip(P17_EXAMPLES, runs))
    walls, failed = {}, []
    for name, (proc, wall) in done:
        walls[name] = wall
        lines = proc.stdout.strip().splitlines() or [""]
        # reddit_integration's speedups stand on a line before its last
        speedups = [x for x in lines if x.startswith("Speedups")]
        print(f"phase 17: (d) examples/torch/{name}.py exited "
              f"{proc.returncode} after {wall:.1f} s on {card}; its last "
              f"line: {' '.join(speedups + lines[-1:])}", flush=True)
        if proc.returncode != 0:
            failed.append(name)
            print(proc.stderr[-4000:], flush=True)
    if failed:
        raise AssertionError(f"phase 17 (d): examples failed: {failed}")
    return walls


def run_train17(torch, np, card):
    """Phase 17: for each config of :data:`P17_LM`, (a) the float32 check,
    (b) the bf16 steps and (but for the last config) ``train``; then the
    last config's ``train`` and (c) whisper-small's restart beside (d) the
    examples.  Returns the flash launches of (a) and (b)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = p12_env(torch, np, "cuda", card)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    reckoned = {a: p17_reckon(torch, p17_config(get_config(a), n), b, s)
                for a, n, b, s in P17_LM}
    # (b) keeps one checkpoint at a time, (c) whisper-small's three
    need = max([rk["checkpoint"] for rk in reckoned.values()
                if p17_checkpoints(rk)]
               + [3 * reckoned[P17_LM[0][0]]["checkpoint"]]) \
        + P12_SLACK_BYTES
    free = shutil.disk_usage(build).free
    if free < need:
        raise AssertionError(f"phase 17 needs {need} B of free disk under "
                             f"{build}, and {free} B are free")
    tmp = Path(tempfile.mkdtemp(prefix="phase17-", dir=build))
    try:
        launched = 0
        for arch, layers, batch, seq in P17_LM:
            t0 = time.perf_counter()
            base = get_config(arch)
            launched += p17_check(env, base, arch)["counts"]["launches"]
            torch.cuda.empty_cache()
            cfg = p17_config(base, layers)
            out = p17_steps(env, cfg, arch, batch, seq)
            launched += int(out["per_step"]["launches"] * P17_STEPS)
            torch.cuda.empty_cache()
            if arch != P17_LM[-1][0]:   # the last one's train beside (d)
                out = p17_train(env, cfg, arch, batch, seq, tmp,
                                p17_checkpoints(reckoned[arch]))
                launched += int(out["per_step"]["launches"]
                                * P17_TRAIN_STEPS)
                torch.cuda.empty_cache()
            print(f"phase 17: {arch} done in {time.perf_counter() - t0:.1f} "
                  "s", flush=True)

        def train_last_then_restart():
            # the last config's train (deepseek-v2's checkpoint, bound by
            # the disk), then whisper-small's restart, beside (d)
            nonlocal launched
            arch, layers, batch, seq = P17_LM[-1]
            t0 = time.perf_counter()
            out = p17_train(env, p17_config(get_config(arch), layers), arch,
                            batch, seq, tmp, p17_checkpoints(reckoned[arch]))
            launched += int(out["per_step"]["launches"] * P17_TRAIN_STEPS)
            torch.cuda.empty_cache()
            print(f"phase 17: (b) {arch}'s train done in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            arch, layers, batch, seq = P17_LM[0]
            cfg = p17_config(get_config(arch), layers)
            t0 = time.perf_counter()
            p12_restart(env, cfg, p17_label("(c)", arch, cfg, batch, seq),
                        batch, seq, tmp, P17_RESTART)
            print(f"phase 17: (c) done in {time.perf_counter() - t0:.1f} s",
                  flush=True)

        t0 = time.perf_counter()
        p17_examples(card, train_last_then_restart)
        torch.cuda.empty_cache()
        print(f"phase 17: (b)'s last train, (c) and (d) done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launched


# -- phase 18: the reduced configs on the card, the port's smoke scripts -------

#: (a) the serving CLI's shape (``python -m repro_torch.launch.serve --arch
#: X --reduced``: batch 4, prompt 64, 32 tokens, seed 0)
P18_SERVE = (4, 64, 32)
P18_SEED = 0
#: (a) the training CLI's batch and sequence (``launch.train``: 8 × 256),
#: and the steps held to the CPU port
P18_TRAIN = (8, 256, 2)
P18_TRAIN_ARCH = "internlm2-1.8b"
#: (a) the head dim the kernel runs every reduced config at: 16 (MLA's
#: q·k 16 + 8 and v 16 alike) zero-padded to the smallest built head dim
P18_KERNEL_HD = 32
#: (a) flash launches and backward recomputes of one reduced internlm2-1.8b
#: train step (2 attention layers under remat: forward twice, back once),
#: predicted by a CPU dry run (``tests/test_torch_phase18.py``)
P18_TRAIN_LAUNCHES = {"launches": 4, "recomputes": 2}
#: (b) ``scripts/torch/<name>.py`` at the CI job's arguments, ``{dir}`` a
#: temporary directory of the chain's own: each chain's steps in order,
#: the four chains together
P18_CHAINS = (("persistence_smoke", (("write", "{dir}"), ("reopen", "{dir}"))),
              ("serving_stress", (("20", "16", "{dir}"),)),
              ("skew_smoke", ((),)),
              ("cluster_smoke", (("write", "{dir}"), ("crash", "{dir}"),
                                 ("reopen", "{dir}"))))
P18_SCRIPT_TIMEOUT_S = 300


def p18_expected(cfg) -> dict:
    """Kernel launches of one reduced prefill: flash once per attention
    (and MLA) layer, and an encoder's layers and the decoder's
    cross-attention; the SSD scan once per SSD layer."""
    mixers = [spec.mixer for spec in cfg.all_specs]
    flash = sum(m in ("attn", "mla") for m in mixers)
    if cfg.encoder is not None:
        flash += cfg.encoder.num_layers + cfg.num_layers
    return {"flash_attention": flash, "ssd_scan": mixers.count("ssd")}


@contextlib.contextmanager
def p18_head_dims(fa):
    """Within it, a Counter of the head dims the flash launcher is called
    at: the launcher the kernel's custom op calls is wrapped (nothing is
    counted as a launch)."""
    seen, launcher = Counter(), fa.flash_attention

    def recording(q, k, v, **kw):
        seen[int(q.shape[-1])] += 1
        return launcher(q, k, v, **kw)

    fa.flash_attention = recording
    try:
        yield seen
    finally:
        fa.flash_attention = launcher


def p18_serve(env, fa, ss, device):
    """(a) each reduced config served at the CLI's shape: through
    ``launch.serve.main`` itself on ``device``, and through ``serve_batch``
    on ``device`` and on the CPU from one set of weights made on the CPU
    (``T.init_params`` from a seeded CPU generator, the CLI's prompts and
    zero frames): the greedy ids equal, each prefill's launches
    :func:`p18_expected`'s, the flash launcher called at head dim
    :data:`P18_KERNEL_HD` only.  {arch: launches of the serve_batch}."""
    torch, np = env.torch, env.np
    from repro_torch import tree
    from repro_torch.configs import get_config, list_archs
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    B, Sq, gen = P18_SERVE
    out = {}
    for arch in list_archs():
        cfg = reduced(get_config(arch))
        want_counts = p18_expected(cfg)
        t0 = time.perf_counter()
        env.reset()
        with p18_head_dims(fa) as cli_hds:
            serve.main(["--arch", arch, "--reduced", "--device", device])
            env.sync()
        cli_counts = {"flash_attention": fa.LAUNCHES["flash_attention"],
                      "ssd_scan": ss.LAUNCHES["ssd_scan"]}
        params = T.init_params(cfg, torch.Generator().manual_seed(P18_SEED),
                               "cpu")
        prompts = np.random.default_rng(P18_SEED).integers(
            0, cfg.vocab_size, (B, Sq), dtype=np.int32)
        frames = None
        if cfg.encoder is not None:
            frames = torch.zeros((B, cfg.encoder.num_frames, cfg.d_model),
                                 dtype=T.dtype_of(cfg))
        want, _ = serve.serve_batch(cfg, params, prompts, gen, frames=frames,
                                    seed=P18_SEED, device="cpu")
        dparams = tree.map(lambda t: t.to(device), params)
        env.reset()
        with p18_head_dims(fa) as hds:
            got, stats = serve.serve_batch(
                cfg, dparams, prompts, gen, seed=P18_SEED, device=device,
                frames=None if frames is None else frames.to(device))
            env.sync()
        counts = {"flash_attention": fa.LAUNCHES["flash_attention"],
                  "ssd_scan": ss.LAUNCHES["ssd_scan"]}
        del dparams
        what = (f"phase 18: (a) {arch} reduced (head dim {cfg.head_dim}, "
                f"{cfg.num_layers} layers, {cfg.param_dtype}) B={B} S={Sq} "
                f"+{gen}")
        same = bool(np.array_equal(got, want))
        first = None if same else np.argwhere(got != want)[0].tolist()
        print(f"{what} on {env.card}: ids equal to the CPU port's {same}"
              f"{'' if same else f' (first difference at {first})'}; "
              f"launches {counts} (CLI {cli_counts}); flash launched at "
              f"head dims {dict(hds)} (CLI {dict(cli_hds)}); prefill "
              f"{stats['prefill_s']:.4f} s, {stats['tokens_per_s']:.1f} "
              f"tokens/s; {time.perf_counter() - t0:.1f} s", flush=True)
        if not same:
            raise AssertionError(f"{what}: the card's greedy ids differ from "
                                 f"the CPU port's at {first}")
        if counts != want_counts or cli_counts != want_counts:
            raise AssertionError(f"{what}: launches {counts}, CLI "
                                 f"{cli_counts}, expected {want_counts}")
        if want_counts["flash_attention"] and \
                set(hds) | set(cli_hds) != {P18_KERNEL_HD}:
            raise AssertionError(f"{what}: flash launched at head dims "
                                 f"{dict(hds)} (CLI {dict(cli_hds)}), not "
                                 f"{P18_KERNEL_HD}")
        out[arch] = counts
    return out


def p18_train(env, fa, device):
    """(a) reduced internlm2-1.8b (head dim 16) for :data:`P18_TRAIN`'s
    steps at the training CLI's batch, on ``device`` and on the CPU port
    from the same weights and batches (``value_and_grad``, then the
    trainer's AdamW update on each side): each step's loss within
    P17_LOSS_TOL relative, every gradient leaf within P17_GRAD_TOL of its
    norm (phase 17 (a)'s limits), launches per step
    :data:`P18_TRAIN_LAUNCHES`, all at head dim :data:`P18_KERNEL_HD`.
    {"launches": over the steps, ...}."""
    torch, np = env.torch, env.np
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    cfg = reduced(get_config(P18_TRAIN_ARCH))
    B, Sq, n_steps = P18_TRAIN
    what = (f"phase 18: (a) {P18_TRAIN_ARCH} reduced (head dim "
            f"{cfg.head_dim}) train B={B} S={Sq}")
    opt = S.make_optimizer(cfg, total_steps=n_steps)
    host = T.init_params(cfg, torch.Generator().manual_seed(P18_SEED), "cpu")
    card = tree.map(lambda t: t.to(device), host)
    hopt, copt = opt.init(host), opt.init(card)
    rng = np.random.default_rng(P18_SEED)
    launched, worst, losses = 0, 0.0, []
    for step in range(n_steps):
        tokens = rng.integers(0, cfg.vocab_size, (B, Sq), dtype=np.int32)
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(np.roll(tokens, -1, 1))}
        env.reset()
        with p18_head_dims(fa) as hds:
            loss, _, grads = S.value_and_grad(
                cfg, card, {k: v.to(device) for k, v in batch.items()})
            env.sync()
        counts = env.read("flash_attention")
        closs, _, cgrads = S.value_and_grad(cfg, host, batch)
        rel = abs(float(loss) - float(closs)) / abs(float(closs))
        leaf_at, leaf = None, 0.0
        for (path, g), c in zip(tree.flatten_with_paths(grads),
                                tree.leaves(cgrads)):
            r = float((g.cpu() - c).norm() / c.norm().clamp_min(1e-30))
            if r >= leaf:
                leaf_at, leaf = tree.path_str(path), r
        print(f"{what} step {step}: loss {float(loss):.6f} on {env.card} vs "
              f"{float(closs):.6f} on the CPU (rel {rel:.3e}, limit "
              f"{P17_LOSS_TOL}); largest leaf error norm / norm {leaf:.3e} "
              f"at {leaf_at} (limit {P17_GRAD_TOL}); launches {counts} at "
              f"head dims {dict(hds)}", flush=True)
        if not rel <= P17_LOSS_TOL or not leaf <= P17_GRAD_TOL:
            raise AssertionError(f"{what} step {step}: the card's loss or "
                                 f"gradients differ from the CPU port's")
        if counts != P18_TRAIN_LAUNCHES or set(hds) != {P18_KERNEL_HD}:
            raise AssertionError(f"{what} step {step}: launches {counts} at "
                                 f"{dict(hds)}, expected "
                                 f"{P18_TRAIN_LAUNCHES} at {P18_KERNEL_HD}")
        card, copt = opt.update(grads, copt, card)
        host, hopt = opt.update(cgrads, hopt, host)
        launched += counts["launches"]
        worst = max(worst, leaf)
        losses.append(float(loss))
    return {"launches": launched, "grad_rel": worst, "losses": losses}


def p18_scripts(card, meanwhile):
    """(b) each chain of :data:`P18_CHAINS` in a temporary directory under
    ``build/`` (removed), its steps in order, each a process of its own on
    the card, the chains started together and ``meanwhile()`` run while
    they run: each step must exit 0 within P18_SCRIPT_TIMEOUT_S.  Returns
    ``meanwhile()``'s result."""
    import os
    import shutil
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)

    def chain(item):
        name, steps = item
        tmp = tempfile.mkdtemp(prefix=f"phase18-{name}-", dir=build)
        done = []
        try:
            for args in steps:
                argv = [a.format(dir=tmp) for a in args]
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable,
                     str(ROOT / "scripts" / "torch" / f"{name}.py"), *argv],
                    cwd=ROOT, env=env, capture_output=True, text=True,
                    timeout=P18_SCRIPT_TIMEOUT_S)
                done.append((" ".join([name] + list(args[:1])), proc,
                             time.perf_counter() - t0))
                if proc.returncode != 0:
                    break
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return done

    with ThreadPoolExecutor(len(P18_CHAINS)) as pool:
        runs = pool.map(chain, P18_CHAINS)          # all submitted at once
        result = meanwhile()
        runs = list(runs)
    failed = []
    for done in runs:
        for label, proc, wall in done:
            last = (proc.stdout.strip().splitlines() or [""])[-1]
            print(f"phase 18: (b) scripts/torch/{label} exited "
                  f"{proc.returncode} after {wall:.1f} s on {card}; its last "
                  f"line: {last}", flush=True)
            if proc.returncode != 0:
                failed.append(label)
                print(proc.stdout[-2000:] + proc.stderr[-4000:], flush=True)
    if failed or any(len(done) != len(steps)
                     for done, (_, steps) in zip(runs, P18_CHAINS)):
        raise AssertionError(f"phase 18 (b): scripts failed: {failed}")
    return result


def run_phase18(torch, np, card):
    """Phase 18: (b) the smoke scripts' chains on the card while (a) serves
    every reduced config and trains reduced internlm2-1.8b in this
    process.  Returns the LM kernels' launches of (a)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    env = p12_env(torch, np, "cuda", card)

    def reduced_configs():
        t0 = time.perf_counter()
        served = p18_serve(env, fa, ss, "cuda")
        trained = p18_train(env, fa, "cuda")
        print(f"phase 18: (a) done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        launched = Counter({"flash_attention": trained["launches"]})
        for counts in served.values():
            launched.update(counts)
        return dict(launched)

    return p18_scripts(card, reduced_configs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    if not (SRC / "repro_torch").is_dir():
        return fail(f"{SRC / 'repro_torch'} is missing: run from a checkout "
                    "of the repository")
    sys.path.insert(0, str(SRC))
    import numpy as np

    import lachesis_torch as lt
    import repro_torch.core as tcore
    from repro_torch.core.executor import TableVal
    from repro_torch.data import device_repartition as tdr
    from repro_torch.data.partition_store import export_layout
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.hash_partition import hash_partition as hp
    from repro_torch.kernels.hash_partition import ref
    from repro_torch.kernels.ssd_scan import ref as ss_ref
    from repro_torch.kernels.ssd_scan import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import mla
    from repro_torch.models import rglru as RG
    from repro_torch.models import transformer as T

    t_start = time.perf_counter()
    card = card_line()
    print(f"phase 0: device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(card, flush=True)

    t1 = time.perf_counter()
    libs = (hp.LIB, fa.LIB, ss.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:      # one nvcc per source
        for lib, fut in [(lib, pool.submit(lib.build, True)) for lib in libs]:
            fut.result()
            print(f"phase 1: built {lib.library.relative_to(ROOT)} in "
                  f"{lib.seconds:.2f} s", flush=True)
            for line in lib.log.splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    print("phase 1: " + line.strip(), flush=True)
    print(f"phase 1: done in {time.perf_counter() - t1:.1f} s", flush=True)

    kernels = check_kernels(torch, hp, ref, tdr, card)

    hp.reset_launches()
    t3 = time.perf_counter()
    tpch1 = run_tpch(torch, np, lt, tcore, TableVal)
    print(f"phase 3: done in {time.perf_counter() - t3:.1f} s; launches "
          f"{dict(hp.LAUNCHES)}", flush=True)
    t4 = time.perf_counter()
    lineitem10, sf10_host_moved, sf10_steps = run_sf10(
        torch, np, lt, tcore, export_layout, hp)
    print(f"phase 4: done in {time.perf_counter() - t4:.1f} s", flush=True)
    launches = dict(hp.LAUNCHES)
    routes = dict(hp.SCATTER_ROUTES)
    print(f"main path launches (phases 3-4): {launches}; scatter_perm "
          f"routes {routes}", flush=True)
    if routes["single_pass"] == 0:
        return fail("the main path never took the single-pass scatter")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phases 5-8: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}",
          flush=True)
    t5 = time.perf_counter()
    kernels["flash_attention"] = run_flash(torch, fa, fa_ref, card)
    print(f"phase 5: done in {time.perf_counter() - t5:.1f} s", flush=True)
    t6 = time.perf_counter()
    kernels["ssd_scan"] = run_ssd(torch, ss, ss_ref, card)
    print(f"phase 6: done in {time.perf_counter() - t6:.1f} s", flush=True)

    counters = [(hp.reset_launches, hp.LAUNCHES),
                (fa.reset_launches, fa.LAUNCHES),
                (ss.reset_launches, ss.LAUNCHES)]
    p7_ids = None
    for phase, arch, kernel, layers in ((7, "internlm2-1.8b",
                                         "flash_attention", 24),
                                        (8, "mamba2-370m", "ssd_scan", 48)):
        tp = time.perf_counter()
        served, ids = run_serve(torch, np, arch, phase, counters, T, serve,
                                get_config)
        if phase == 7:
            p7_ids = ids["bfloat16"]
        for dtype, counts in served.items():
            if counts[kernel] != layers:
                return fail(f"{arch} {dtype}: {kernel} launched "
                            f"{counts[kernel]} times in one prefill, not "
                            f"once per layer ({layers})")
        launches[kernel] = served["bfloat16"][kernel]
        print(f"phase {phase}: done in {time.perf_counter() - tp:.1f} s",
              flush=True)

    hp.reset_launches()
    t9 = time.perf_counter()
    child = run_durable(torch, np, lt, tcore, lineitem10, tpch1)
    phase9 = {k: v + child[k] for k, v in hp.LAUNCHES.items()}
    for k in ("hash_partition", "scatter_perm"):
        if phase9[k] == 0:
            return fail(f"phase 9 never launched {k}")
        launches[k] += phase9[k]
    launches["hash_partition_padded"] += phase9["hash_partition_padded"]
    print(f"phase 9: done in {time.perf_counter() - t9:.1f} s on {card}; "
          f"launches (parent + child) {phase9}", flush=True)

    t10 = time.perf_counter()
    phase10 = run_service(torch, np, lt, tcore, hp)
    for k in ("hash_partition", "hash_partition_padded", "scatter_perm"):
        if phase10.get(k, 0) == 0:
            return fail(f"phase 10 never launched {k}")
        launches[k] += phase10[k]
    print(f"phase 10: done in {time.perf_counter() - t10:.1f} s on {card}; "
          f"launches {phase10}", flush=True)

    t11 = time.perf_counter()
    phase11 = run_cluster()
    for k in ("hash_partition", "hash_partition_padded", "scatter_perm"):
        if phase11.get(k, 0) == 0:
            return fail(f"phase 11 never launched {k}")
        launches[k] += phase11[k]
    print(f"phase 11: done in {time.perf_counter() - t11:.1f} s on {card}; "
          f"launches {phase11}", flush=True)

    t12 = time.perf_counter()
    phase12 = run_training(torch, np, lt, tcore, card)
    for k, v in phase12.items():
        if v == 0:
            return fail(f"phase 12 never launched {k}")
        launches[k] += v
    print(f"phase 12: done in {time.perf_counter() - t12:.1f} s on {card}; "
          f"launches over the LMs' train steps {phase12}", flush=True)

    t13 = time.perf_counter()
    mesh_launches = p13_mesh(torch, np, lt, tcore, hp, lineitem10,
                             sf10_host_moved, sf10_steps, export_layout, card)
    for k, v in mesh_launches.items():
        launches[k] += v
    print(f"phase 13 (a): done in {time.perf_counter() - t13:.1f} s",
          flush=True)
    tm = time.perf_counter()
    p13_mla_route(torch, fa, fa_ref, mla, card)
    print(f"phase 13: MLA route done in {time.perf_counter() - tm:.1f} s",
          flush=True)
    for part, (arch, layers, dtypes, check) in zip("bcd", P13_LM):
        tp = time.perf_counter()
        launches["flash_attention"] += p13_lm(
            torch, np, T, serve, get_config, counters, fa, arch, layers,
            dtypes, check, card)
        print(f"phase 13 ({part}): {arch} done in "
              f"{time.perf_counter() - tp:.1f} s", flush=True)
    print(f"phase 13: done in {time.perf_counter() - t13:.1f} s on {card}",
          flush=True)

    t14 = time.perf_counter()
    p14_flash(torch, fa, fa_ref, card)
    print(f"phase 14 (a): done in {time.perf_counter() - t14:.1f} s",
          flush=True)
    tp = time.perf_counter()
    launches["flash_attention"] += p14_recurrentgemma(
        torch, np, T, RG, serve, get_config, counters, fa, card)
    print(f"phase 14 (b)-(c): done in {time.perf_counter() - tp:.1f} s",
          flush=True)
    tp = time.perf_counter()
    launches["flash_attention"] += p14_whisper(
        torch, np, T, serve, get_config, counters, fa, card)
    print(f"phase 14 (d): done in {time.perf_counter() - tp:.1f} s",
          flush=True)
    print(f"phase 14: done in {time.perf_counter() - t14:.1f} s on {card}",
          flush=True)

    from repro_torch.models import layers as L
    t15 = time.perf_counter()
    launches["flash_attention"] += p15_flash_decode(
        torch, np, T, L, get_config, counters, fa, card)
    print(f"phase 15 (a): done in {time.perf_counter() - t15:.1f} s",
          flush=True)
    tp = time.perf_counter()
    launches["flash_attention"] += p15_remat(torch, np, get_config, counters,
                                             fa, card)
    print(f"phase 15 (b): done in {time.perf_counter() - tp:.1f} s",
          flush=True)
    tp = time.perf_counter()
    p15_dry_run(card)
    print(f"phase 15 (c): done in {time.perf_counter() - tp:.1f} s",
          flush=True)
    tp = time.perf_counter()
    launches["flash_attention"] += p15_one_rank(
        torch, np, T, get_config, counters, fa, p7_ids, card)
    p15_op_overhead(torch, fa, ss, card)
    print(f"phase 15 (d): done in {time.perf_counter() - tp:.1f} s",
          flush=True)
    print(f"phase 15: done in {time.perf_counter() - t15:.1f} s on {card}",
          flush=True)

    t16 = time.perf_counter()
    phase16 = p16_mesh(torch, np, lt, tcore, lineitem10, sf10_host_moved,
                       tpch1, card, hp.reset_launches,
                       lambda: dict(hp.LAUNCHES))
    del lineitem10, sf10_host_moved, tpch1
    for counts in phase16["launches"].values():
        for k, v in counts.items():
            launches[k] += v
    print(f"phase 16: done in {time.perf_counter() - t16:.1f} s on {card}; "
          f"launches {phase16['launches']}", flush=True)

    t17 = time.perf_counter()
    phase17 = run_train17(torch, np, card)
    if phase17 == 0:
        return fail("phase 17 never launched flash_attention")
    launches["flash_attention"] += phase17
    print(f"phase 17: done in {time.perf_counter() - t17:.1f} s on {card}; "
          f"flash launches over (a) and (b) {phase17}", flush=True)

    t18 = time.perf_counter()
    phase18 = run_phase18(torch, np, card)
    for k, v in phase18.items():
        if v == 0:
            return fail(f"phase 18 never launched {k}")
        launches[k] += v
    print(f"phase 18: done in {time.perf_counter() - t18:.1f} s on {card}; "
          f"launches over (a) {phase18}", flush=True)

    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        return fail(f"kernels never launched on the main path: {missing}")
    for name, row in kernels.items():
        row["launches"] = launches[name]
    print("kernels: " + ", ".join(kernels), flush=True)
    print(f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--phase9-child"]:
            code = p9_child(json.loads(sys.argv[2]))
        elif sys.argv[1:2] == ["--phase11-child"]:
            code = p11_child(json.loads(sys.argv[2]))
        else:
            code = main()
    except Exception as exc:            # report any phase's failure, exit 1
        import traceback
        traceback.print_exc()
        code = fail(f"{type(exc).__name__}: {exc}")
    sys.exit(code)
