#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Lachesis on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

0. card and versions;
1. build the hand-written hash-partition kernels from ``src/`` with nvcc;
2. hold each kernel against its plain torch version on the card, bit for
   bit, at the main path's shapes (2^26 keys, the shape bucket of 60,000,000
   rows) and at edge shapes, and time kernel, plain version and library
   yardstick;
3. the main path at TPC-H SF 1 through ``lachesis_torch.Session`` on the
   card: q04-, q17- and q02-like workloads over a round-robin store (device
   shuffles) and over a store partitioned on the join keys (elided), equal
   to the port's host backend;
4. write lineitem at SF 10 (60,000,000 rows) hash-partitioned, repartition
   it device to device, and hold both layouts to the host backend's bits.

The kernels' launch counters are zeroed before phase 3 and read after
phase 4; every kernel must have run on that path.  The second-to-last line
is the kernel table as JSON, the last line the device record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
SOURCE = "src/repro_torch/kernels/hash_partition/csrc/hash_partition.cu"
REPLACES = {
    "hash_partition": "src/repro/kernels/hash_partition/hash_partition.py:83",
    "hash_partition_padded":
        "src/repro/kernels/hash_partition/hash_partition.py:142",
    "scatter_perm": "src/repro/kernels/hash_partition/hash_partition.py:208",
}
MAIN_N = 1 << 26                    # shape bucket of SF-10 lineitem
SF10_LINES = 60_000_000
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


# -- phase 4: SF 10 write and device-to-device repartition ---------------------

def run_sf10(torch, np, lt, tcore, export_layout):
    rng = np.random.default_rng(10)
    n_orders, n_parts = 15_000_000, 2_000_000
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
    layouts = {}
    for backend in ("device", "host"):
        sess = lt.Session(num_workers=M, backend=backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        written = sess.write("lineitem", lineitem, by_order)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        moved_ds, moved = sess.repartition("lineitem", by_part)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
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
        d, h = layouts["device"][i], layouts["host"][i]
        if not np.array_equal(d["counts"], h["counts"]):
            raise AssertionError(f"SF-10 {step}: counts differ")
        for k, col in h["columns"].items():
            got = d["columns"][k]
            if got.dtype != col.dtype or got.shape != col.shape \
                    or not np.array_equal(got, col):
                raise AssertionError(f"SF-10 {step}: column {k} differs")
        print(f"phase 4: SF-10 {step} layout bit-equal to the host backend "
              f"({int(h['counts'].sum())} rows)", flush=True)


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
    from repro_torch.kernels.hash_partition import hash_partition as hp
    from repro_torch.kernels.hash_partition import ref

    t_start = time.perf_counter()
    card = card_line()
    print(f"phase 0: device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(card, flush=True)

    hp.build(force=True)
    print(f"phase 1: built {hp.LIBRARY.relative_to(ROOT)} in "
          f"{hp.BUILD_SECONDS:.2f} s", flush=True)
    for line in hp.BUILD_LOG.splitlines():
        if "Compiling entry" in line or "registers" in line:
            print("phase 1: " + line.strip(), flush=True)

    kernels = check_kernels(torch, hp, ref, tdr, card)

    hp.reset_launches()
    t3 = time.perf_counter()
    run_tpch(torch, np, lt, tcore, TableVal)
    print(f"phase 3: done in {time.perf_counter() - t3:.1f} s; launches "
          f"{dict(hp.LAUNCHES)}", flush=True)
    t4 = time.perf_counter()
    run_sf10(torch, np, lt, tcore, export_layout)
    print(f"phase 4: done in {time.perf_counter() - t4:.1f} s", flush=True)
    launches = dict(hp.LAUNCHES)
    print(f"main path launches (phases 3-4): {launches}", flush=True)
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
        code = main()
    except Exception as exc:            # report any phase's failure, exit 1
        import traceback
        traceback.print_exc()
        code = fail(f"{type(exc).__name__}: {exc}")
    sys.exit(code)
