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
        arr = np.asarray(keys).reshape(-1)
        if arr.size == 0:
            return self
        vals, cnts = np.unique(arr, return_counts=True)
        self.n += int(arr.size)
        for v, c in zip(vals.tolist(), cnts.tolist()):
            self._counters[int(v)] = self._counters.get(int(v), 0) + int(c)
        # Misra-Gries decrement: shed mass until <= k counters survive.
        while len(self._counters) > self.k:
            dec = min(self._counters.values())
            self._counters = {
                key: cnt - dec for key, cnt in self._counters.items() if cnt > dec
            }
            if not self._counters:
                break
        return self

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
