"""Sharding advisor — Lachesis's selection loop applied to LM shardings.

The port of the JAX package's ``core/sharding_advisor.py`` (DESIGN §2,
beyond the paper): for an LM step function the "partitioner candidates"
are sharding variants (config and spec knobs), the "historical
statistics" the roofline terms of each variant, and the selector Eq. 2's
argmin over the dominant term.  The decision keeps every candidate's
record, so it is auditable the way a ``PartitioningDecision`` is.

The default scorer is the port's ``launch/dryrun.analyze_cell``, as the
reference's is its own: a roofline of one traced step on a fake world of
256 (512) ranks, read off the ops each rank runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class ShardingCandidate:
    name: str
    extra_cfg: Dict[str, Any] = field(default_factory=dict)
    variant: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ShardingDecision:
    cell: Tuple[str, str, bool]
    winner: ShardingCandidate
    dominant_term_s: float
    trail: List[Dict[str, Any]]          # per-candidate roofline records


DEFAULT_CANDIDATES: Dict[str, List[ShardingCandidate]] = {
    "train": [
        ShardingCandidate("baseline"),
        ShardingCandidate("accum_half", {"accum_steps": 2}),
        ShardingCandidate("accum_1", {"accum_steps": 1}),
        ShardingCandidate("remat_dots", {"remat_policy": "dots"}),
    ],
    "decode": [
        ShardingCandidate("baseline"),
        ShardingCandidate("cache_seq_shard", {}, {"cache_seq_shard": True}),
        ShardingCandidate("flash_decode", {}, {"flash_decode": True}),
    ],
    "prefill": [ShardingCandidate("baseline")],
}


def dominant_term(record: Dict[str, Any]) -> float:
    return max(record["compute_s"], record["memory_s"],
               record["collective_s"])


def advise(arch: str, shape: str, *, multi_pod: bool = False,
           candidates: Optional[Sequence[ShardingCandidate]] = None,
           analyze=None) -> ShardingDecision:
    """Score every candidate with ``analyze(arch, shape, multi_pod=,
    extra_cfg=, variant=, verbose=)`` (a dict with ``compute_s``,
    ``memory_s`` and ``collective_s``; by default the dry run's
    ``analyze_cell``, which needs no card) and return the argmin of the
    dominant term; a candidate whose scoring raises is recorded and
    skipped."""
    if analyze is None:
        from ..launch.dryrun import analyze_cell as analyze
    from ..configs import SHAPES
    kind = SHAPES[shape].kind
    cands = list(candidates) if candidates is not None \
        else DEFAULT_CANDIDATES[kind]

    trail: List[Dict[str, Any]] = []
    best: Optional[Tuple[float, ShardingCandidate]] = None
    for cand in cands:
        try:
            rec = analyze(arch, shape, multi_pod=multi_pod,
                          extra_cfg=cand.extra_cfg or None,
                          variant=cand.variant or None, verbose=False)
        except Exception as e:                    # candidate may not lower
            trail.append({"candidate": cand.name, "error": repr(e)})
            continue
        rec["candidate"] = cand.name
        trail.append(rec)
        score = dominant_term(rec)
        if best is None or score < best[0]:
            best = (score, cand)
    if best is None:
        raise RuntimeError("no sharding candidate lowered successfully")
    return ShardingDecision(cell=(arch, shape, multi_pod), winner=best[1],
                            dominant_term_s=best[0], trail=trail)
