"""The seeded inputs: token ids drawn on the host with numpy, the same on
every machine for the same seed.

Each stream is ``np.random.default_rng([seed, stream, index])``, so every
training step and every serving call gets rows of its own, and a run can
draw any step's or call's rows again (the references do).  Seeds may be
any whole number; they are taken modulo 2**64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

TRAIN, PROMPTS, SAMPLE = 1, 2, 3


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream,
                                  int(index) % (1 << 64)])


def train_batch(seed: int, step: int, batch: int, seq: int,
                vocab: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s rows: uniform ids in [0, vocab), (batch, seq + 1)
    int32, split into inputs and next-token labels."""
    ids = rng(seed, TRAIN, step).integers(0, vocab, (batch, seq + 1),
                                          dtype=np.int32)
    return {"tokens": ids[:, :-1].copy(), "labels": ids[:, 1:].copy()}


def prompts(seed: int, call: int, batch: int, length: int,
            vocab: int) -> np.ndarray:
    """Serving call ``call``'s prompts: uniform ids, (batch, length)
    int32."""
    return rng(seed, PROMPTS, call).integers(0, vocab, (batch, length),
                                             dtype=np.int32)


def sample(seed: int, n_items: int, k: int) -> np.ndarray:
    """``k`` distinct indices of ``n_items``, drawn from the seed, sorted;
    the last item is always among them."""
    k = min(k, n_items)
    if k <= 0:
        return np.zeros((0,), np.int64)
    rest = rng(seed, SAMPLE).choice(n_items - 1, size=k - 1, replace=False)
    return np.sort(np.concatenate([rest, [n_items - 1]]).astype(np.int64))
