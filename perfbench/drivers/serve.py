"""Serving traffic: calls of the port's ``launch/serve.py::serve_batch``,
each with ``batch`` fresh prompts of ``prompt_len`` tokens and
``gen_tokens`` greedy tokens each, offered at a fixed rate: call k is due
``k / calls_per_s`` seconds into the window and starts then, or when the
call before it returns if that is later (one process serves them in
turn).  Calls that start within the window are served; the window ends
when the last returns.  Below the port's capacity every call starts when
due; above it the calls run back to back and the queue grows.

A request's time to its first token runs from its call's due time to the
moment the port, its prefill and first token done and synchronised,
enters its first decode step: a span the benchmark records around the
port's ``models/transformer.decode_step`` while the window runs.

Traffic keys: ``batch``, ``prompt_len``, ``gen_tokens``,
``calls_per_s``, ``warmup_calls``, ``check_requests`` (requests the check
samples), ``trace_calls``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import common as C
from ..yardstick import tokens as TOK
from . import log

#: requests the reference takes at once
REF_ROWS = 4


class State:
    pass


def _prompts(cell, seed: int, call: int) -> np.ndarray:
    tr = cell.traffic
    return TOK.prompts(seed, call, tr["batch"], tr["prompt_len"],
                       cell.spec["config"]["vocab_size"])


@contextlib.contextmanager
def _first_decode_span(marks: List):
    """Append the host time at which each call's first decode step
    starts."""
    from repro_torch.models import transformer as TM
    inner = TM.decode_step

    def decode_step(*args, **kw):
        if marks and marks[-1] is None:
            marks[-1] = time.perf_counter()
        return inner(*args, **kw)

    TM.decode_step = decode_step
    try:
        yield
    finally:
        TM.decode_step = inner


def setup(cell, seed: int, device) -> State:
    s = State()
    s.cell, s.seed, s.device = cell, seed, device
    s.params = cell.ref.init_params(cell.spec, seed, device)
    s.calls = []
    log("weights made")
    for k in range(cell.traffic["warmup_calls"]):
        _call(s, -1 - k)
        log(f"warm-up call {k + 1} done")
    return s


def _call(s: State, index: int) -> Dict:
    from repro_torch.launch.serve import serve_batch
    tr = s.cell.traffic
    prompts = _prompts(s.cell, s.seed, index)
    t0 = time.perf_counter()
    out, stats = serve_batch(s.cell.program_cfg, s.params, prompts,
                             tr["gen_tokens"], device=s.device)
    return {"index": index, "t0": t0, "t1": time.perf_counter(),
            "generated": out, "prefill_s": stats["prefill_s"],
            "decode_s": stats["decode_s"]}


def window(s: State, seconds: float) -> Dict:
    tr = s.cell.traffic
    marks: List = []
    calls = []
    t0 = time.perf_counter()
    with _first_decode_span(marks):
        while True:
            due = t0 + len(calls) / tr["calls_per_s"]
            now = time.perf_counter()
            if max(due, now) - t0 >= seconds:
                break
            if now < due:
                time.sleep(due - now)
            marks.append(None)
            c = _call(s, len(calls))
            c["due"] = due
            c["first"] = marks[-1] if marks[-1] is not None else c["t1"]
            calls.append(c)
    elapsed = calls[-1]["t1"] - t0
    B = tr["batch"]
    ttft = np.repeat([(c["first"] - c["due"]) * 1e3 for c in calls], B)
    s.calls = calls
    n = len(calls)
    return {"attempted": n * B, "failed": 0, "seconds": elapsed,
            "calls": n, "prefill_s": [c["prefill_s"] for c in calls],
            "decode_s": [c["decode_s"] for c in calls],
            "late_s": max(c["t0"] - c["due"] for c in calls),
            "e2e": {"serve_ttft_p95_ms": float(np.percentile(ttft, 95)),
                    "serve_tokens_per_s": n * B * (tr["prompt_len"]
                                                   + tr["gen_tokens"])
                    / elapsed}}


def traced(s: State) -> None:
    for k in range(s.cell.traffic["trace_calls"]):
        _call(s, len(s.calls) + k)


def release(s: State, record: Dict) -> Dict:
    """The sampled requests (drawn from the seed, the last one always
    among them): their call, row and served tokens."""
    tr = s.cell.traffic
    B = tr["batch"]
    picks = TOK.sample(s.seed, len(s.calls) * B, tr["check_requests"])
    reqs = [{"call": s.calls[i // B]["index"], "row": int(i % B),
             "served": s.calls[i // B]["generated"][i % B].copy()}
            for i in picks]
    s.params = None
    s.calls = []
    return {"requests": reqs}


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------

def reference_logits(cell, seed: int, requests: List[Dict], device,
                     precision: str = "fp32") -> List[torch.Tensor]:
    """For each request, the reference's logits (gen, V) at the positions
    that chose its served tokens: one forward pass over its prompt and
    its served tokens but the last."""
    tr, spec, ref = cell.traffic, cell.spec, cell.ref
    Lp = tr["prompt_len"]
    positions = list(range(Lp - 1, Lp - 1 + tr["gen_tokens"]))
    out: List[torch.Tensor] = []
    with C.full_float32():
        flat = C.flatten(ref.init_params(spec, seed, device))
        params = C.build_tree([(p, t.float()) for p, t in flat])
        del flat
        for i in range(0, len(requests), REF_ROWS):
            rows = []
            for r in requests[i:i + REF_ROWS]:
                prompt = _prompts(cell, seed, r["call"])[r["row"]]
                rows.append(np.concatenate([prompt, r["served"][:-1]]))
            toks = torch.as_tensor(np.stack(rows).astype(np.int32),
                                   device=device)
            logits = ref.logits_at(spec, params, toks, positions, precision)
            out += list(logits)
    return out


def logit_gap(logits: List[torch.Tensor], chosen: List[np.ndarray]) -> float:
    """The widest gap by which a chosen token's logit lies below the best
    at its position."""
    worst = 0.0
    for lg, ids in zip(logits, chosen):
        ids = torch.as_tensor(np.asarray(ids, np.int64), device=lg.device)
        if int(ids.max()) >= lg.shape[-1] or int(ids.min()) < 0:
            return float("inf")
        gap = lg.max(dim=-1).values - lg.gather(1, ids[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def check(cell, seed: int, program: Dict, device) -> Dict[str, float]:
    reqs = program["requests"]
    if not reqs:
        return {"logit_gap": float("inf")}
    logits = reference_logits(cell, seed, reqs, device)
    return {"logit_gap": logit_gap(logits, [r["served"] for r in reqs])}


def calibrate(cell, seed: int, device, controls: bool) -> Dict:
    """The port's logit gap over ``check_requests`` requests of a short run
    at the cell's load (enough calls to hold them); with ``controls`` the
    float8 control's (the token its logits put first at each position of
    the same requests) and a served token altered where it is produced."""
    tr = cell.traffic
    s = setup(cell, seed, device)
    n_calls = -(-tr["check_requests"] // tr["batch"])
    s.calls = [_call(s, k) for k in range(n_calls)]
    program = release(s, {})
    del s
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reqs = program["requests"]
    ref32 = reference_logits(cell, seed, reqs, device)
    out = {"program": {"logit_gap": logit_gap(ref32, [r["served"]
                                                      for r in reqs])}}
    if controls:
        ctrl = reference_logits(cell, seed, reqs, device, precision="fp8")
        out["control"] = {"logit_gap": logit_gap(
            ref32, [lg.argmax(dim=-1).cpu().numpy() for lg in ctrl])}
        altered = [r["served"].copy() for r in reqs]
        altered[0][0] = (altered[0][0] + 1) % cell.spec["config"]["vocab_size"]
        out["altered_token"] = {"logit_gap": logit_gap(ref32, altered)}
    return out
