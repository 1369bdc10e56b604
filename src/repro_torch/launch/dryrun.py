"""Multi-node dry run: trace every (arch × shape × mesh) cell on a fake world.

The port of the JAX package's ``launch/dryrun.py``, and the proof that the
distribution config is coherent without the hardware: a fake process
group of 256 (512) ranks builds the production ``DeviceMesh``
(``launch/mesh.py``: 32 × 8, or 2 × 32 × 8 over two pods); every input
is a ``meta`` tensor (``launch/specs.py``) distributed as a ``DTensor``
by the sharding rules (``launch/shardings.py``); and one train step,
prefill or decode step runs as rank 0 sees it, under the counting mode of
``launch/op_analysis.py``, which totals the FLOPs, bytes and collectives
one device would run.  Nothing executes: meta tensors hold no values and
the fake group sends nothing, so this is the one entry point of the port
that needs no card, as the reference's runs on 512 placeholder host
devices.  The kernels are reached through their custom ops' fake
implementations, as the card's dispatch reaches them.

The record keeps the reference's keys.  ``collective_s`` prices the bytes
of collectives over "model" (inside a node) at NVLink's rate and the rest
at the network's, and records both parts.  ``bytes_per_device`` is an
upper bound (eager ops' inputs and outputs, nothing fused), and
``memory_analysis.temp_bytes`` the peak of the step's live meta bytes.
The reference's ``xla_cost_analysis_once`` (XLA's own cost analysis,
which counts a scanned body once) has no counterpart and is left out.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import SHAPES, get_config, list_archs, shapes_for
from ..configs.base import ShapeSpec
from ..core.sharding_bridge import P
from ..models import layers as _layers
from ..pjit_utils import enable_spmd, spmd_enabled
from . import op_analysis, shardings, specs, steps
from .mesh import (HBM_BW, NETWORK_BW, NVLINK_AXES, NVLINK_BW,
                   PEAK_FLOPS_BF16, axis_sizes, fake_world,
                   make_production_mesh, production_shape)


def _shape(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def lower_cell(arch: str, shape_name: Union[str, ShapeSpec], *,
               multi_pod: bool = False,
               extra_cfg: Optional[Dict[str, Any]] = None,
               variant: Optional[Dict[str, Any]] = None, mesh=None):
    """Distribute one cell's inputs on the mesh; returns (run, meta):
    ``run()`` runs the step on them, ``meta`` holds the mesh, config,
    shape and the step's inputs.  ``mesh`` defaults to the production
    mesh on the live fake world.  Switches SPMD and the flash-decode flag
    on or off for the cell; :func:`analyze_cell` restores both.

    ``extra_cfg`` overrides ArchConfig fields (remat_policy, accum_steps,
    mla_absorbed, ...); ``variant`` toggles spec-level knobs:
    cache_seq_shard (flash-decode cache layout), fsdp_params (decode
    weights sharded over DP too), flash_decode (the plain twin, for the
    one-query calls the decode kernel's op does not take; the others take
    the op on meta tensors, as on the card)."""
    variant = variant or {}
    _layers.FLASH_DECODE_ENABLED = bool(variant.get("flash_decode", False))
    if mesh is None:
        mesh = make_production_mesh(multi_pod)
    cfg = get_config(arch)
    if extra_cfg:
        cfg = dataclasses.replace(cfg, **extra_cfg)
    shape = _shape(shape_name)
    enable_spmd(True)
    place = shardings.distribute

    if shape.kind == "train":
        opt = steps.make_optimizer(cfg)
        inp = specs.input_specs(cfg, shape, opt)
        state_ps = shardings.train_state_pspecs(cfg, inp["state"], mesh)
        batch_ps = shardings.batch_pspecs(cfg, shape, mesh)
        args = (place(mesh, inp["state"], state_ps),
                place(mesh, inp["batch"], batch_ps))
        fn = steps.make_train_step(cfg, opt)
    elif shape.kind == "prefill":
        inp = specs.input_specs(cfg, shape)
        param_ps = shardings.param_pspecs(cfg, inp["params"], mesh)
        if cfg.param_count() >= shardings.FSDP_THRESHOLD:
            param_ps = shardings.shard_over_dp(cfg, param_ps, inp["params"],
                                               mesh)
        batch_ps = shardings.batch_pspecs(cfg, shape, mesh)
        args = (place(mesh, inp["params"], param_ps),
                place(mesh, inp["batch"], batch_ps))
        fn = steps.make_prefill_step(cfg)
    else:  # decode
        inp = specs.input_specs(cfg, shape)
        param_ps = shardings.param_pspecs(cfg, inp["params"], mesh)
        if (cfg.param_count() >= shardings.FSDP_THRESHOLD
                or variant.get("fsdp_params")):
            param_ps = shardings.shard_over_dp(cfg, param_ps, inp["params"],
                                               mesh)
        cache_ps = shardings.cache_pspecs(
            cfg, inp["cache"], shape.global_batch, mesh,
            seq_shard_model=variant.get("cache_seq_shard", False))
        tok_dp = shardings.batch_axes_for(shape.global_batch, cfg, mesh)
        tok_spec = P(tok_dp if len(tok_dp) != 1 else tok_dp[0], None) \
            if tok_dp else P(None, None)
        args = (place(mesh, inp["params"], param_ps),
                place(mesh, inp["cache"], cache_ps),
                place(mesh, inp["tokens"], tok_spec), inp["pos"])
        fn = steps.make_decode_step(cfg)
    return (lambda: fn(*args)), {"mesh": mesh, "cfg": cfg, "shape": shape,
                                 "args": args}


def model_flops(cfg, shape: ShapeSpec) -> float:
    """Useful global FLOPs: 6·N·tokens to train, 2·N·tokens forward."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch


def analyze_cell(arch: str, shape_name: Union[str, ShapeSpec], *,
                 multi_pod: bool = False,
                 extra_cfg: Optional[Dict[str, Any]] = None,
                 variant: Optional[Dict[str, Any]] = None,
                 verbose: bool = True, mesh=None) -> Dict[str, Any]:
    """Trace one cell and return its roofline record.  Without ``mesh``
    the fake world of the production mesh is started for the call and
    destroyed after it (unless one of that size was live); with one, the
    cell runs on it."""
    t0 = time.time()
    shape = _shape(shape_name)
    flag, spmd = _layers.FLASH_DECODE_ENABLED, spmd_enabled()
    world = (contextlib.nullcontext() if mesh is not None
             else fake_world(math.prod(production_shape(multi_pod)[0])))
    try:
        with world:
            run, meta = lower_cell(arch, shape, multi_pod=multi_pod,
                                   extra_cfg=extra_cfg, variant=variant,
                                   mesh=mesh)
            mesh_ = meta["mesh"]
            grad = torch.enable_grad() if shape.kind == "train" \
                else torch.no_grad()
            with grad, implicit_replication():
                out, totals = op_analysis.count(run, mesh=mesh_)
            arg_bytes = shardings.local_bytes(
                [a for a in meta["args"] if not isinstance(a, int)])
            out_bytes = shardings.local_bytes(out)
            sizes = axis_sizes(mesh_)
            del run, out, meta["args"]
    finally:
        _layers.FLASH_DECODE_ENABLED = flag
        enable_spmd(spmd)
    cfg = meta["cfg"]
    chips = math.prod(sizes.values())
    flops, bytes_acc = totals.flops, totals.hbm_bytes
    by_axis = totals.axis_bytes()
    nvlink = sum(b for a, b in by_axis.items() if a in NVLINK_AXES)
    network = totals.collective_bytes - nvlink
    mflops = model_flops(cfg, shape)
    terms = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": bytes_acc / HBM_BW,
             "collective_s": nvlink / NVLINK_BW + network / NETWORK_BW}
    bottleneck = max(terms, key=terms.get)
    rec = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(s) for s in sizes.values()), "chips": chips,
        "kind": shape.kind,
        "extra_cfg": {k: str(v) for k, v in (extra_cfg or {}).items()},
        "variant": {k: str(v) for k, v in (variant or {}).items()},
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "bytes_per_device_is": "eager ops' inputs + outputs, nothing fused: "
                               "an upper bound on HBM traffic",
        "collective_bytes_per_device": totals.collective_bytes,
        "collectives": totals.collectives,
        "collectives_by_axis": totals.by_axis,
        "collective_ops": totals.collective_ops,
        **terms,
        "collective_nvlink_s": nvlink / NVLINK_BW,
        "collective_network_s": network / NETWORK_BW,
        "bottleneck": bottleneck.replace("_s", ""),
        "model_flops_global": mflops,
        "useful_flop_ratio": mflops / (flops * chips) if flops else 0.0,
        "kernel_calls": totals.kernel_calls,
        "memory_analysis": {"argument_bytes": arg_bytes,
                            "output_bytes": out_bytes,
                            "temp_bytes": totals.peak_bytes},
        "compile_s": round(time.time() - t0, 1),
    }
    if verbose:
        ma = rec["memory_analysis"]
        print(f"[{rec['mesh']}] {arch} × {shape.name}: "
              f"args={ma['argument_bytes']/2**30:.2f}GiB "
              f"temp={ma['temp_bytes']/2**30:.2f}GiB "
              f"flops/dev={flops:.3e} bytes/dev={bytes_acc:.3e} "
              f"coll/dev={totals.collective_bytes:.3e}  "
              f"bottleneck={rec['bottleneck']} ({rec['compile_s']}s)",
              flush=True)
    return rec


def run_all(multi_pod: bool, out_path: Optional[str] = None,
            archs=None) -> Dict[str, Any]:
    results, failures = [], []
    for arch in (archs or list_archs()):
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            try:
                results.append(analyze_cell(arch, shape.name,
                                            multi_pod=multi_pod))
            except Exception as e:               # a failure here is a bug
                traceback.print_exc()
                failures.append({"arch": arch, "shape": shape.name,
                                 "error": repr(e)})
    payload = {"multi_pod": multi_pod, "results": results,
               "failures": failures}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {out_path}: {len(results)} ok, {len(failures)} failed")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k",
                    choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        payload = run_all(args.multi_pod, args.out,
                          archs=[args.arch] if args.arch else None)
        raise SystemExit(1 if payload["failures"] else 0)
    rec = analyze_cell(args.arch, args.shape, multi_pod=args.multi_pod)
    print(json.dumps(rec, indent=1, default=str))


if __name__ == "__main__":
    main()
