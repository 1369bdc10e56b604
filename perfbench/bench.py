"""The harness: one run of one cell.

:func:`load_cell` finds everything by the names in ``BENCHMARK.json``: the
cell's configuration (``configs/<config>.json``, whose ``reference`` names
its family module under ``reference/``), its traffic
(``traffic/<traffic>.json``, whose ``driver`` names the module under
``drivers/`` that plays it), its limits (``limits/<workload>.json``) and
the per-layer readers (``metrics/<name>.py``).  No code here names a
cell.

:func:`run` then makes the set-up, the measured window, in a traced run
the traced steps, the reference's check, and returns the result line.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

from . import judge

ROOT = Path(__file__).resolve().parent
#: modules no run may load: the JAX package, JAX itself, the old harness
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "lachesis", "benchmarks")


@dataclass
class Cell:
    workload: Dict
    spec: Dict
    traffic: Dict
    limits: Dict
    e2e: List[Dict]
    per_layer: List[Dict]
    ref: Any = None
    driver: Any = None
    program_cfg: Any = None


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def family(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")


def driver_module(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``, loaded by file name (metric
    names may hold dots)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, workload: str):
    """(end-to-end, per-layer) metric entries a cell reports: those that
    list it, and those with no list whose moved metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def load_cell(workload: str) -> Cell:
    bench = load_json(ROOT.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    spec = load_json(ROOT.parent / configs[w["config"]]["file"])
    traffic = load_json(ROOT / "traffic" / f"{w['traffic']}.json")
    limits = load_json(ROOT / "limits" / f"{workload}.json")
    e2e, per = cell_metrics(bench, workload)
    return Cell(workload=w, spec=spec, traffic=traffic,
                limits=limits["limits"], e2e=e2e, per_layer=per)


def attach_program(cell: Cell, program_cfg=None) -> Cell:
    """The reference family, the driver and the port's configuration, the
    last checked against the configuration file's sizes."""
    cell.ref = family(cell.spec["reference"])
    cell.driver = driver_module(cell.traffic["driver"])
    if program_cfg is None:
        from repro_torch.configs import get_config
        program_cfg = get_config(cell.spec["program_arch"])
    check_program(cell.ref.program_fields(cell.spec), program_cfg)
    cell.program_cfg = program_cfg
    return cell


def check_program(want: Dict, cfg) -> None:
    """Raise unless the port's configuration has every size the file
    states."""
    for key, value in want.items():
        if key == "mixers":
            got = [s.mixer for s in cfg.all_specs]
        elif key == "ffns":
            got = [s.ffn for s in cfg.all_specs]
        else:
            got = cfg
            for part in key.split("."):
                got = getattr(got, part)
        if got != value and not (isinstance(value, float)
                                 and isinstance(got, (int, float))
                                 and float(got) == value):
            raise ValueError(f"the port's {cfg.name} has {key} = {got!r}; "
                             f"the configuration file states {value!r}")


def forbidden_modules() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def device_info(device, trace) -> Dict:
    import torch
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def _peak(device) -> int:
    import torch
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def _reset_peak(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=None) -> Dict:
    """One run: set-up, window, (traced steps), release, reference check.
    Returns the result line's object."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    drv = cell.driver
    log(f"[perfbench] {time.perf_counter() - t_start:.3f} s after start: "
        f"set-up begins")
    state = drv.setup(cell, seed, device)
    setup_peak = _peak(device)
    _reset_peak(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    log(f"[perfbench] set-up {setup_s:.3f} s, window {seconds} s")
    record = drv.window(state, seconds)
    log(f"[perfbench] window {record['seconds']:.3f} s, "
        f"{record['attempted']} attempted"
        + (f", at most {record['late_s']:.3f} s late" if "late_s" in record
           else ""))
    window_peak = _peak(device)
    tr = None
    if trace:
        from . import trace as T
        tr = T.traced(lambda: drv.traced(state))
        log(f"[perfbench] traced {tr.window_s:.3f} s, device busy "
            f"{tr.busy_s:.3f} s; kernel ops: " + ", ".join(
                f"{k} x{len(v)} {sum(c.device_s for c in v):.4f} s"
                for k, v in sorted(tr.calls.items())))
    peak = max(setup_peak, window_peak, _peak(device))
    program = drv.release(state, record)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    gaps = drv.check(cell, seed, program, device)
    log(f"[perfbench] reference {time.perf_counter() - t_ref:.3f} s")
    table = judge.checks(gaps, cell.limits)
    failed = int(record.get("failed", 0))
    correct = judge.passed(table) and failed == 0
    ctx = {"cell": cell, "record": record, "trace": tr}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(record["e2e"], setup_s=setup_s,
                      peak_mem_gib=window_peak / 2**30)
        metrics = {}
        for m in cell.e2e:
            if m["name"] not in values:
                raise KeyError(f"driver {cell.traffic['driver']!r} gives no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(record["attempted"]),
           "failed": failed, "metrics": metrics,
           "device": dict(device_info(device, tr), memory_peak_bytes=peak)}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = table
    return out


def format_checks(table: Dict) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            + ("" if math.isfinite(c["value"]) and c["value"] <= c["limit"]
               else "  FAILED")
            for name, c in table.items()]
