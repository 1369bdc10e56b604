"""Hand-written CUDA hash-partition kernels for Hopper, and their launchers.

The port of the Pallas TPU kernels in the JAX package's
``kernels/hash_partition/hash_partition.py`` (DESIGN §5):

* :func:`hash_partition` — Wang hash + ``% m`` + an ``(m,)`` histogram;
* :func:`hash_partition_padded` — the same over a power-of-two bucket, rows
  at position ``>= n_valid`` routed to the overflow partition ``m``;
* :func:`scatter_perm` — the stable counting-sort destination of every row.

The kernels live in ``csrc/hash_partition.cu`` (design notes there).  They
are compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain
C interface at first use — never at import, so the CPU tests import this
module freely — and loaded with :mod:`ctypes`.  Each launcher takes CUDA
tensors only: it checks device, dtype, shape and contiguity, allocates its
outputs and scratch with torch, launches on the current stream, raises on a
launch error, and counts its launches in :data:`LAUNCHES`.  The plain
versions are in :mod:`.ref`; :mod:`.ops` picks between the two by device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "hash_partition.cu"
#: build output inside the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libhash_partition.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: rows one warp owns in the scatter's tile passes (a multiple of 32)
SCATTER_TILE_ROWS = 2048
#: most rows a launch takes: destinations and counts are int32
MAX_ROWS = 2 ** 31 - 1

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"hash_partition": 0, "hash_partition_padded": 0,
                            "scatter_perm": 0}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: what the last build printed (``-Xptxas -v``: registers, shared memory)
BUILD_LOG = ""
BUILD_SECONDS = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the hash-partition kernels")
    return nvcc


def build(force: bool = False) -> Path:
    """Compile ``csrc/hash_partition.cu`` into :data:`LIBRARY` unless a
    build of the same source is already there.  The library is written to
    a temporary name and renamed into place, so concurrent builders never
    load a half-written file."""
    global BUILD_LOG, BUILD_SECONDS
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stamp = LIBRARY.with_suffix(".sha256")
    if (not force and LIBRARY.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return LIBRARY
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest)
    return LIBRARY


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.hp_max_bins.argtypes = []
            lib.hp_max_bins.restype = i32
            lib.hp_hash_partition.argtypes = [p, p, p, i64, i64, i32, i32, p]
            lib.hp_hash_partition.restype = i32
            lib.hp_scatter_perm.argtypes = [p, p, p, p, i64, i32, i32, p]
            lib.hp_scatter_perm.restype = i32
            _LIB = lib
        return _LIB


def max_bins() -> int:
    """Most histogram bins (``m``, or ``m + 1`` padded) the kernels hold."""
    return int(_lib().hp_max_bins())


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


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _hash(keys: torch.Tensor, n_valid: int, num_partitions: int,
          padded: bool, kernel: str) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(keys, "keys")
    lib = _lib()
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
                                    int(padded), _stream())
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1
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
    ``[0, bins)`` move no real row; their own dest is unspecified."""
    _check(pids, "pids")
    _check(counts, "counts")
    if counts.device != pids.device:
        raise ValueError("pids and counts must be on the same device")
    lib = _lib()
    bins = counts.numel()
    _check_bins(lib, bins)
    n = pids.numel()
    dest = torch.empty(n, dtype=torch.int32, device=pids.device)
    if n == 0:
        return dest
    n_tiles = -(-n // SCATTER_TILE_ROWS)
    scratch = torch.empty(bins * n_tiles, dtype=torch.int32,
                          device=pids.device)
    with torch.cuda.device(pids.device):
        err = lib.hp_scatter_perm(pids.data_ptr(), counts.data_ptr(),
                                  dest.data_ptr(), scratch.data_ptr(), n,
                                  bins, SCATTER_TILE_ROWS, _stream())
    _raise_on(err, "scatter_perm")
    LAUNCHES["scatter_perm"] += 1
    return dest
