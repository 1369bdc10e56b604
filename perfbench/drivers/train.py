"""Training traffic: the port's donated train step
(``launch/steps.py::make_train_step(cfg, make_optimizer(...),
donate=True)``) driven as ``launch/train.py::train`` drives it: each step
its own fresh rows to the card, the step, the loss read.

Set-up builds the one train state, from the seed's weights, and runs the
first ``checked_steps`` steps through the same call and feed as the
window; they warm up every shape, and the numbers the check compares are
read from them: each step's loss, each leaf's first gradient norm from the
optimizer's first moment after step 1 (m = (1 − b1)·g), and each leaf's
change after the last checked step, before the next step overwrites the
parameters.  The window goes on from the next step with that same state.

Traffic keys: ``batch``, ``seq_len``, ``checked_steps``, ``peak_lr``,
``total_steps`` (the trainer's warm-up-cosine schedule), ``trace_steps``.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import torch

from ..reference import common as C
from ..yardstick import tokens as TOK
from . import log


class State:
    pass


def _batch(cell, seed: int, step: int, device) -> Dict[str, torch.Tensor]:
    tr = cell.traffic
    b = TOK.train_batch(seed, step, tr["batch"], tr["seq_len"],
                        cell.spec["config"]["vocab_size"])
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def _norms(tree) -> List[float]:
    return [float(torch.linalg.vector_norm(t, dtype=torch.float32))
            for _, t in C.flatten(tree)]


def setup(cell, seed: int, device) -> State:
    from repro_torch.launch import steps
    tr = cell.traffic
    s = State()
    s.cell, s.seed, s.device = cell, seed, device
    opt = steps.make_optimizer(cell.program_cfg, peak_lr=tr["peak_lr"],
                               total_steps=tr["total_steps"])
    params = cell.ref.init_params(cell.spec, seed, device)
    s.state = {"params": params, "opt": opt.init(params)}
    s.step_fn = steps.make_train_step(cell.program_cfg, opt, donate=True)
    s.b1 = opt.b1
    s.next_step = 1
    s.readings = {"loss": [], "paths": [C.path_name(p) for p, _ in
                                        C.flatten(params)]}
    log("weights and optimizer state made")
    for i in range(tr["checked_steps"]):
        s.readings["loss"].append(_step(s))
        log(f"checked step {i + 1} done")
        if i == 0:
            s.readings["grad"] = [n / (1 - s.b1)
                                  for n in _norms(s.state["opt"].m)]
    p0 = cell.ref.init_params(cell.spec, seed, device)
    s.readings["change"] = [
        float(torch.linalg.vector_norm(p.float() - q.float()))
        for (_, p), (_, q) in zip(C.flatten(s.state["params"]),
                                  C.flatten(p0))]
    del p0
    _sync(device)
    return s


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step(s: State) -> float:
    batch = _batch(s.cell, s.seed, s.next_step, s.device)
    s.state, metrics = s.step_fn(s.state, batch)
    s.next_step += 1
    return float(metrics["loss"])            # waits for the step


def window(s: State, seconds: float) -> Dict:
    """Steps until ``seconds`` have passed; the window ends with the last
    step's loss read."""
    tr = s.cell.traffic
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(_step(s))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    n = len(losses)
    tokens = n * tr["batch"] * tr["seq_len"]
    return {"attempted": n,
            "failed": sum(1 for x in losses if not math.isfinite(x)),
            "seconds": elapsed, "steps": n, "tokens": tokens,
            "e2e": {"train_tokens_per_s": tokens / elapsed}}


def traced(s: State) -> None:
    for _ in range(s.cell.traffic["trace_steps"]):
        _step(s)


def release(s: State, record: Dict) -> Dict:
    readings = s.readings
    s.state = s.step_fn = None
    return readings


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------

def reference(cell, seed: int, device, precision: str = "fp32",
              half_batch: bool = False) -> Dict:
    """The checked steps in float32 (or the control's float8 GEMMs): each
    step's loss, each leaf's first clipped gradient norm, each leaf's
    change after the last step.  ``half_batch`` plants a fault: the
    loss's mean over half the rows (half the positions of a one-row
    batch)."""
    tr, spec, ref = cell.traffic, cell.spec, cell.ref
    with C.full_float32():
        flat = C.flatten(ref.init_params(spec, seed, device))
        paths = [p for p, _ in flat]
        dtypes = [t.dtype for _, t in flat]
        params = [t.float() for _, t in flat]
        del flat
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        out = {"loss": []}
        for i in range(1, tr["checked_steps"] + 1):
            b = _batch(cell, seed, i, device)
            tok, lab = b["tokens"], b["labels"]
            if half_batch:
                if tok.shape[0] > 1:
                    tok, lab = tok[:tok.shape[0] // 2], lab[:lab.shape[0] // 2]
                else:
                    cut = tok.shape[1] // 2
                    tok, lab = tok[:, :cut], lab[:, :cut]
            leaves = [p.detach().requires_grad_(True) for p in params]
            loss = ref.loss(spec, C.build_tree(list(zip(paths, leaves))),
                            tok, lab, precision)
            grads = torch.autograd.grad(loss, leaves)
            del leaves
            out["loss"].append(float(loss.detach()))
            if i == 1:
                scale = C.clip_scale(grads)
                out["grad"] = [float(torch.linalg.vector_norm(g) * scale)
                               for g in grads]
            C.adamw_update(params, list(grads), m, v, dtypes, i,
                           C.learning_rate(i, tr["peak_lr"],
                                           tr["total_steps"]))
            del grads, loss
        del m, v
        p0 = [t for _, t in C.flatten(ref.init_params(spec, seed, device))]
        out["change"] = [float(torch.linalg.vector_norm(p - q.float()))
                         for p, q in zip(params, p0)]
    return out


def check(cell, seed: int, program: Dict, device) -> Dict[str, float]:
    from ..judge import MOVING_LEAF, train_gaps
    ref = reference(cell, seed, device)
    g = ref["grad"]
    floor = MOVING_LEAF * statistics.median(g)
    log(f"{sum(x < floor for x in g)} of {len(g)} leaves left out of "
         f"change_gap")
    return train_gaps(program, ref)


def calibrate(cell, seed: int, device, controls: bool) -> Dict:
    """The port's gaps on this seed; with ``controls`` also the float8
    control's and the half-batch fault's, each against the same float32
    reference (a state left unchanged reads 1 on ``change_gap`` by
    definition and needs no run)."""
    from ..judge import train_gaps, worst_leaves
    s = setup(cell, seed, device)
    program = release(s, {})
    del s
    _free(device)
    ref32 = reference(cell, seed, device)
    out = {"program": train_gaps(program, ref32)}
    out["worst"] = {k: worst_leaves(program, ref32, k)
                    for k in ("grad", "change")}
    if controls:
        _free(device)
        ctrl = reference(cell, seed, device, precision="fp8")
        out["control"] = train_gaps(ctrl, ref32)
        out["worst_control"] = {
            k: worst_leaves(dict(ctrl, paths=program["paths"]), ref32, k)
            for k in ("grad", "change")}
        _free(device)
        out["half_batch"] = train_gaps(
            reference(cell, seed, device, half_batch=True), ref32)
        frozen = dict(program, change=[0.0] * len(program["change"]))
        out["unchanged_state"] = train_gaps(frozen, ref32)
    return out


def _free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

