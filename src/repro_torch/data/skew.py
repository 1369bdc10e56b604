"""Skew detection utilities: heavy-hitter sketch + Zipf key generator.

The sketch is a batch-vectorized Misra-Gries summary: ``k`` counters that
overestimate no key and underestimate any key by at most ``n / (k + 1)``.
The Observer runs it over each candidate's key column during the existing
per-candidate stats pass, so hot-key detection costs one ``np.unique``
per scanned dataset — no second pass over the data.

``zipf_keys`` is the canonical skewed key generator, promoted here from
``service/drivers.py`` so benchmarks and drivers share one definition.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["HeavyHitterSketch", "zipf_keys"]

_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def _int_keys(vals: np.ndarray) -> Optional[np.ndarray]:
    """``[int(v) for v in vals]`` as int64, or None when int64 cannot hold
    it (unsigned keys past 2^63 - 1, non-finite or huge floats, non-numeric
    keys).  Floats truncate toward zero, as ``int`` does."""
    kind = vals.dtype.kind
    if kind in "bi":
        return vals.astype(np.int64)
    if kind == "u":
        return vals.astype(np.int64) if int(vals.max()) <= _INT64_MAX \
            else None
    if kind == "f" and np.isfinite(vals).all() \
            and float(np.abs(vals).max()) < 2.0 ** 63:
        return np.trunc(vals).astype(np.int64)
    return None


def zipf_keys(
    n: int,
    n_keys: int,
    alpha: float,
    rng: Optional[np.random.Generator] = None,
    seed: int = 0,
) -> np.ndarray:
    """Draw ``n`` Zipf(``alpha``)-distributed keys in ``[0, n_keys)``.

    Pass ``rng`` to draw from an existing generator (preserving its
    sequence for callers that interleave other draws); otherwise a fresh
    ``default_rng(seed)`` is used.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(float(alpha), int(n)) - 1, int(n_keys) - 1).astype(
        np.int64
    )


class HeavyHitterSketch:
    """Misra-Gries heavy-hitter summary with batch updates.

    Any key whose true frequency exceeds ``n / (k + 1)`` is guaranteed to
    be among the counters; reported counts underestimate by at most the
    total decrement, so ``max_fraction()`` is a lower bound on the hottest
    key's share — exactly the conservative direction for a split trigger.
    """

    def __init__(self, k: int = 8) -> None:
        if k < 1:
            raise ValueError(f"sketch size k must be >= 1, got {k}")
        self.k = int(k)
        self._counters: Dict[int, int] = {}
        self.n = 0

    def update(self, keys: Sequence[int]) -> "HeavyHitterSketch":
        """Add a batch of keys.  Keys are counted as ``int(key)``, the
        counters kept in insertion order (earlier counters first, then the
        batch's keys ascending), exactly as a per-key dict update would
        keep them — but merged and shed with numpy, so a batch of millions
        of distinct keys costs a few vector passes, not a Python loop."""
        arr = np.asarray(keys).reshape(-1)
        if arr.size == 0:
            return self
        return self.update_unique(*np.unique(arr, return_counts=True))

    def update_unique(self, vals: np.ndarray,
                      cnts: np.ndarray) -> "HeavyHitterSketch":
        """:meth:`update` for a batch already reduced by
        ``np.unique(keys, return_counts=True)`` (a caller that needs the
        distinct keys anyway sorts them once)."""
        if vals.size == 0:
            return self
        self.n += int(cnts.sum())
        ikeys = _int_keys(vals)
        old = self._counters
        if ikeys is None or not all(_INT64_MIN <= k <= _INT64_MAX
                                    for k in old):
            # keys int64 cannot hold: the per-key dict update
            for v, c in zip(vals.tolist(), cnts.tolist()):
                old[int(v)] = old.get(int(v), 0) + int(c)
            self._shed(np.array(list(old), dtype=object),
                       np.array(list(old.values()), dtype=np.int64))
            return self
        # int() truncation may merge neighbours; ikeys stays sorted
        starts = np.flatnonzero(np.r_[True, ikeys[1:] != ikeys[:-1]])
        bkeys = ikeys[starts]
        bcnts = np.add.reduceat(cnts.astype(np.int64), starts)
        fresh = np.ones(bkeys.size, bool)
        old_cnts = []
        for key, cnt in old.items():
            i = int(np.searchsorted(bkeys, key))
            if i < bkeys.size and bkeys[i] == key:
                cnt += int(bcnts[i])
                fresh[i] = False
            old_cnts.append(cnt)
        self._shed(np.concatenate([np.array(list(old), np.int64),
                                   bkeys[fresh]]),
                   np.concatenate([np.array(old_cnts, np.int64),
                                   bcnts[fresh]]))
        return self

    def _shed(self, keys: np.ndarray, cnts: np.ndarray) -> None:
        """Misra-Gries decrement: shed mass until <= k counters survive —
        each round subtracts the smallest count and drops the counters it
        empties, keeping their order."""
        while keys.size > self.k:
            dec = cnts.min()
            keep = cnts > dec
            keys, cnts = keys[keep], cnts[keep] - dec
        self._counters = dict(zip(keys.tolist(), cnts.tolist()))

    def counters(self) -> Dict[int, int]:
        return dict(self._counters)

    def max_fraction(self) -> float:
        """Lower bound on the hottest key's share of all updates."""
        if self.n == 0 or not self._counters:
            return 0.0
        return max(self._counters.values()) / float(self.n)

    def heavy_hitters(self, fraction: float) -> List[Tuple[int, float]]:
        """Keys whose (lower-bound) share is at least ``fraction``."""
        if self.n == 0:
            return []
        out = [
            (key, cnt / float(self.n))
            for key, cnt in self._counters.items()
            if cnt / float(self.n) >= fraction
        ]
        out.sort(key=lambda kv: -kv[1])
        return out
