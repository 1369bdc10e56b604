"""Partitioning ⇄ workload matching (paper §3.2, Alg. 4).

Subgraph isomorphism is NP-complete in general; the two-terminal property of
partitioner subgraphs lets us match by *path-signature sets*: the stored
partitioning ``f_D`` matches a candidate subgraph ``IG^(s_D, p_i)`` iff the
sorted multiset of root→leaf path signatures is equal.  On a match the
consumer's shuffle (the subgraph ending at ``p_i``) is elided — on TPU, the
corresponding all-to-all/all-gather never enters the lowered program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from .ir import IRGraph
from .partitioner import PartitionerCandidate, search, merge


@dataclass
class MatchResult:
    matched: bool
    partition_nodes: List[int]      # partition nodes in consumer IR whose
                                    # shuffle can be elided
    checked: int = 0                # candidate subgraphs inspected


def partitioning_match(f_D: Optional[PartitionerCandidate], dataset: str,
                       a: IRGraph) -> MatchResult:
    """Alg. 4: find all subgraphs of consumer IR ``a`` isomorphic to the
    stored partitioning ``f_D`` of ``dataset``."""
    if f_D is None or not f_D.is_keyed:
        return MatchResult(False, [])
    ssset_D = f_D.signature_set()
    s_D = a.find_scanner(dataset)
    if s_D is None:
        return MatchResult(False, [])

    matched_nodes: List[int] = []
    checked = 0
    # candidate isomorphic subgraphs = merged two-terminal subgraphs from the
    # same scan node; reuse Alg. 1+2 to construct IG^(s_D, p_i)
    for cand in merge(a, search(a, s_D)):
        checked += 1
        # the strategy label participates in the signature via the partition
        # node token, so hash vs range partitionings never cross-match
        if cand.signature_set() == ssset_D:
            matched_nodes.append(cand.origin[1])
    return MatchResult(bool(matched_nodes), matched_nodes, checked)


def plan_shuffles(a: IRGraph, stored: dict) -> Tuple[List[int], List[int]]:
    """Query-scheduler hook: split the consumer IR's partition nodes into
    (elided, required) given ``stored: dataset -> PartitionerCandidate``.

    A partition node is elided iff it terminates a candidate whose signature
    matches the persistent partitioning of the dataset it reads from.
    """
    elided: List[int] = []
    for dataset, f_D in stored.items():
        res = partitioning_match(f_D, dataset, a)
        elided.extend(res.partition_nodes)
    required = [p for p in a.partition_nodes if p not in set(elided)]
    return sorted(set(elided)), sorted(required)
