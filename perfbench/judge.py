"""The numbers that decide ``correct``, each the gap between what the
port produced and what the float32 reference works out, and their
comparison with the cell's limits (``limits/<workload>.json``).

Training (three checked steps): ``loss_gap``, the largest relative gap of
a step's loss; ``grad_gap``, the largest gap between a leaf's first
gradient norm (after clipping, as the optimizer got it) and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf; ``change_gap``, the same for each leaf's change after the
three steps, over the leaves whose reference gradient is at least a
thousandth of the median leaf's (smaller ones move by round-off alone).
``grad_gap_median`` takes the
median leaf's gradient gap instead of the widest, where a few small
leaves' round-off swings the widest; a cell's limits file names the
numbers it compares.  Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

#: a leaf counts for the change only if its reference gradient norm is at
#: least this share of the median leaf's
MOVING_LEAF = 1e-3


def _finite(xs) -> bool:
    return bool(np.all(np.isfinite(np.asarray(xs, dtype=np.float64))))


def _leaf_gaps(prog: Sequence[float], ref: Sequence[float], keep=None):
    """Each leaf's |program − reference| over the larger of the
    reference's norm of that leaf and of the median leaf; None where the
    program gave no finite number for every leaf."""
    p = np.asarray(prog, np.float64)
    r = np.asarray(ref, np.float64)
    if p.shape != r.shape:
        return None
    if keep is not None:
        p, r = p[keep], r[keep]
    if p.size == 0 or not _finite(p):
        return None
    floor = float(np.median(r))
    return np.abs(p - r) / np.maximum(np.maximum(r, floor), 1e-30)


def _norm_gap(prog, ref, keep=None, how=np.max) -> float:
    gaps = _leaf_gaps(prog, ref, keep)
    return math.inf if gaps is None else float(how(gaps))


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    lp = np.asarray(prog["loss"], np.float64)
    lr = np.asarray(ref["loss"], np.float64)
    loss_gap = (float(np.max(np.abs(lp - lr) / np.abs(lr)))
                if lp.shape == lr.shape and _finite(lp) else math.inf)
    g = np.asarray(ref["grad"], np.float64)
    keep = g >= MOVING_LEAF * float(np.median(g))
    return {"loss_gap": loss_gap,
            "grad_gap": _norm_gap(prog["grad"], ref["grad"]),
            "change_gap": _norm_gap(prog["change"], ref["change"], keep),
            "grad_gap_median": _norm_gap(prog["grad"], ref["grad"],
                                         how=np.median)}


def checks(gaps: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {"value", "limit"}} for every limited number; a number the
    run could not produce reads inf."""
    return {name: {"value": float(gaps.get(name, math.inf)),
                   "limit": float(limit)}
            for name, limit in limits.items()}


def passed(table: Dict) -> bool:
    return bool(table) and all(math.isfinite(c["value"])
                               and c["value"] <= c["limit"]
                               for c in table.values())


def worst_leaves(prog: Dict, ref: Dict, key: str, n: int = 3):
    """The ``n`` leaves with the widest gap of ``key`` ("grad" or
    "change"): (path, gap, program's norm, reference's norm)."""
    p = np.asarray(prog[key], np.float64)
    r = np.asarray(ref[key], np.float64)
    floor = max(float(np.median(r)), 1e-30)
    gap = np.abs(p - r) / np.maximum(r, floor)
    paths = prog.get("paths") or [str(i) for i in range(len(p))]
    order = np.argsort(-gap)[:n]
    return [(paths[i], float(gap[i]), float(p[i]), float(r[i]))
            for i in order]
