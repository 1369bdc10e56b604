"""Device dispatch for the hash-partition kernel family.

A CUDA tensor goes to the hand-written kernel (which raises if it cannot
build or launch); a CPU tensor goes to the bit-identical plain version.
The choice follows the tensor's device and nothing else.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import hash_partition as _k
from . import ref as _ref


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no hash-partition path for device {t.device}")


def partition_ids(keys: torch.Tensor, num_partitions: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (N,) int32 → (pids (N,) int32, histogram (m,) int32)."""
    if _route(keys) == "cuda":
        return _k.hash_partition(keys, num_partitions)
    return _ref.hash_partition_ref(keys, num_partitions)


def padded_partition_ids(keys: torch.Tensor, n_valid: int,
                         num_partitions: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape-bucketed dispatch: keys (B,) + valid count → (pids (B,) with
    padding → m, counts (m+1,))."""
    if _route(keys) == "cuda":
        return _k.hash_partition_padded(keys, n_valid, num_partitions)
    return _ref.hash_partition_padded_ref(keys, n_valid, num_partitions)


def scatter_permutation(pids: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """Counting-sort destination permutation: (pids, matching histogram) →
    dest (N,) int32, the stable O(N) replacement for
    ``argsort(pids, stable=True)`` + inversion."""
    if _route(pids) == "cuda":
        return _k.scatter_perm(pids, counts)
    return _ref.scatter_perm_ref(pids, counts)
