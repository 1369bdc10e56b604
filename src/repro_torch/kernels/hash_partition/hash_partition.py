"""Hand-written CUDA hash-partition kernels for Hopper, and their launchers.

The port of the Pallas TPU kernels in the JAX package's
``kernels/hash_partition/hash_partition.py`` (DESIGN §5):

* :func:`hash_partition` — Wang hash + ``% m`` + an ``(m,)`` histogram;
* :func:`hash_partition_padded` — the same over a power-of-two bucket, rows
  at position ``>= n_valid`` routed to the overflow partition ``m``;
* :func:`scatter_perm` — the stable counting-sort destination of every row:
  one pass with a decoupled look-back over tiles of
  :data:`SCATTER_TILE_ROWS` rows up to :data:`SCATTER_SINGLE_PASS_MAX_BINS`
  bins, three passes above.

The kernels live in ``csrc/hash_partition.cu`` (design notes there).  They
are compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface at first use (:data:`LIB`, see :mod:`.._build`).  Each launcher
takes CUDA tensors only: it checks device, dtype, shape and contiguity, allocates its
outputs and scratch with torch, launches on the current stream, raises on a
launch error, and counts its launches in :data:`LAUNCHES`.  The plain
versions are in :mod:`.ref`; :mod:`.ops` picks between the two by device.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._build import (CudaLibrary, count_launch, raise_on, reset_counts,
                      stream)

#: rows of one single-pass scatter tile, and the most bins the single pass
#: takes (more go to the three passes): the kernel's ``kTileRows`` and
#: ``kSinglePassMaxBins``, which the tests hold equal to these
SCATTER_TILE_ROWS = 16384
SCATTER_SINGLE_PASS_MAX_BINS = 512
#: most rows a launch takes: destinations and counts are int32
MAX_ROWS = 2 ** 31 - 1

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"hash_partition": 0, "hash_partition_padded": 0,
                            "scatter_perm": 0}
#: ``scatter_perm`` launches by route since the last :func:`reset_launches`
SCATTER_ROUTES: Dict[str, int] = {"single_pass": 0, "three_pass": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES, SCATTER_ROUTES)


def scatter_route(bins: int) -> str:
    """The scatter kernels ``bins`` bins go to."""
    return ("single_pass" if bins <= SCATTER_SINGLE_PASS_MAX_BINS
            else "three_pass")


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hp_max_bins.argtypes = []
    lib.hp_max_bins.restype = i32
    lib.hp_hash_partition.argtypes = [p, p, p, i64, i64, i32, i32, p]
    lib.hp_hash_partition.restype = i32
    lib.hp_scatter_perm.argtypes = [p, p, p, p, i64, i32, p]
    lib.hp_scatter_perm.restype = i32
    lib.hp_scatter_scratch_bytes.argtypes = [i64, i32]
    lib.hp_scatter_scratch_bytes.restype = i64


LIB = CudaLibrary("hash_partition",
                  Path(__file__).resolve().parent / "csrc"
                  / "hash_partition.cu", _declare)


def max_bins() -> int:
    """Most histogram bins (``m``, or ``m + 1`` padded) the kernels hold."""
    return int(LIB.lib().hp_max_bins())


def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be 1-D and contiguous")
    if t.numel() > MAX_ROWS:
        raise ValueError(f"{name} has {t.numel()} rows: the kernels index "
                         f"and count rows in int32, at most {MAX_ROWS}")


def _check_bins(lib: ctypes.CDLL, bins: int) -> None:
    limit = int(lib.hp_max_bins())
    if bins < 1 or bins > limit:
        raise ValueError(f"{bins} partition bins: the kernels hold 1 to "
                         f"{limit} bins in shared memory")


def _hash(keys: torch.Tensor, n_valid: int, num_partitions: int,
          padded: bool, kernel: str) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(keys, "keys")
    lib = LIB.lib()
    m = int(num_partitions)
    bins = m + 1 if padded else m
    _check_bins(lib, bins)
    n = keys.numel()
    pids = torch.empty(n, dtype=torch.int32, device=keys.device)
    counts = torch.zeros(bins, dtype=torch.int32, device=keys.device)
    if n == 0:
        return pids, counts
    with torch.cuda.device(keys.device):
        err = lib.hp_hash_partition(keys.data_ptr(), pids.data_ptr(),
                                    counts.data_ptr(), n, int(n_valid), m,
                                    int(padded), stream())
    raise_on(err, kernel)
    count_launch(LAUNCHES, kernel)
    return pids, counts


def hash_partition(keys: torch.Tensor, num_partitions: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (N,) int32 on CUDA → (pids (N,) int32, counts (m,) int32)."""
    return _hash(keys, keys.numel(), num_partitions, False, "hash_partition")


def hash_partition_padded(keys: torch.Tensor, n_valid: int,
                          num_partitions: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys (B,) int32 on CUDA + valid count → (pids (B,) int32 with rows
    ``>= n_valid`` → m, counts (m+1,) int32)."""
    return _hash(keys, int(n_valid), num_partitions, True,
                 "hash_partition_padded")


def scatter_perm(pids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(pids (N,) int32, counts (bins,) int32) on CUDA → dest (N,) int32,
    row i's position in the stable sort of ``pids``.  Pids outside
    ``[0, bins)`` move no real row; their own dest is 0.  One launch up to
    :data:`SCATTER_SINGLE_PASS_MAX_BINS` bins, three above; the library
    sizes the scratch (:data:`SCATTER_ROUTES` counts the route)."""
    _check(pids, "pids")
    _check(counts, "counts")
    if counts.device != pids.device:
        raise ValueError("pids and counts must be on the same device")
    lib = LIB.lib()
    bins = counts.numel()
    _check_bins(lib, bins)
    n = pids.numel()
    dest = torch.empty(n, dtype=torch.int32, device=pids.device)
    if n == 0:
        return dest
    scratch = torch.empty(int(lib.hp_scatter_scratch_bytes(n, bins)),
                          dtype=torch.uint8, device=pids.device)
    with torch.cuda.device(pids.device):
        err = lib.hp_scatter_perm(pids.data_ptr(), counts.data_ptr(),
                                  dest.data_ptr(), scratch.data_ptr(), n,
                                  bins, stream())
    raise_on(err, "scatter_perm")
    count_launch(LAUNCHES, "scatter_perm")
    count_launch(SCATTER_ROUTES, scatter_route(bins))
    return dest
