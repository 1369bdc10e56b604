"""Plain torch versions of the hash-partition kernels.

Bit-identical twins of the JAX package's jnp oracles.  torch on the CPU
has no right shift for ``uint32``, so the Wang hash runs in int64 with the
value masked back to 32 bits after each multiply; the returned int64 tensor
holds the unsigned 32-bit hash, and ``% m`` is taken on that unsigned value.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MASK32 = 0xFFFFFFFF


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """Deterministic 32-bit integer mix (matches core.ir._mix_hash): an
    int64 tensor holding the uint32 hash of ``x``'s low 32 bits."""
    x = x.to(torch.int64) & MASK32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & MASK32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & MASK32
    x = x ^ (x >> 15)
    return x


def hash_partition_ref(keys: torch.Tensor, num_partitions: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (N,) int32 → (pids (N,) int32, counts (m,) int32)."""
    pids = (wang_hash(keys) % num_partitions).to(torch.int32)
    counts = torch.bincount(pids, minlength=num_partitions).to(torch.int32)
    return pids, counts


def hash_partition_padded_ref(keys: torch.Tensor, n_valid: int,
                              num_partitions: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (B,) padded past ``n_valid`` → (pids (B,) int32 with padding →
    m, counts (m+1,) int32 where counts[m] = B - n_valid)."""
    B = keys.shape[0]
    pid = (wang_hash(keys) % num_partitions).to(torch.int32)
    valid = torch.arange(B, device=keys.device) < int(n_valid)
    pids = torch.where(valid, pid, torch.full_like(pid, num_partitions))
    counts = torch.bincount(pids, minlength=num_partitions + 1)
    return pids, counts.to(torch.int32)


def scatter_perm_ref(pids: torch.Tensor,
                     counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dest[i] = row i's position in the *stable* sort of ``pids`` — the
    inverse of ``argsort(pids, stable=True)`` (``counts`` is not needed
    here; the kernel seeds its offsets from it)."""
    n = pids.shape[0]
    order = torch.argsort(pids, stable=True)
    dest = torch.empty(n, dtype=torch.int32, device=pids.device)
    dest[order] = torch.arange(n, dtype=torch.int32, device=pids.device)
    return dest
