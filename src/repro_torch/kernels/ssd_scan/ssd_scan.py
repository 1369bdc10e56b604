"""Hand-written CUDA chunked SSD (Mamba-2) for Hopper, and its launcher.

The port of the Pallas TPU kernel in the JAX package's
``kernels/ssd_scan/ssd_scan.py``: per (batch, head), the chunks of length
``chunk`` in order, the intra-chunk quadratic form, the inter-chunk term
from the carried (P, N) state, and the state update; zero initial state.
The kernels live in ``csrc/ssd_scan.cu`` (design notes there) and are built
at first use (:data:`LIB`, see :mod:`.._build`): the dtype picks one —
bfloat16 runs on the tensor cores (``mma.sync``; W, x·w and the state
operand rounded to bfloat16), float32 on the CUDA cores in full float32.

:func:`ssd_scan` takes CUDA tensors only.  It reads x, dt, B and C through
their strides (the last dimension contiguous), so the model's slices of
the convolution output cost no copy.  It raises ``ValueError`` on what the
kernel does not take and counts its launches in :data:`LAUNCHES`.  The
plain version is in :mod:`.ref`; :mod:`.ops` picks between the two by
device.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._build import (CudaLibrary, count_launch, raise_on, reset_counts,
                      stream)

#: the kernel's limits (``kMaxP``, ``kMaxN``, ``kMaxChunk`` in the source);
#: P, N and chunk must also be multiples of 16
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}
#: backward passes since the last :func:`reset_launches`, each one the
#: plain twin's VJP recomputed from the saved inputs (:mod:`.ops`)
RECOMPUTES: Dict[str, int] = {"ssd_scan": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES, RECOMPUTES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_forward.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32, i32,
                                i32, i32, p, p]
    lib.ssd_forward.restype = i32


LIB = CudaLibrary("ssd_scan",
                  Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
                  _declare)


def check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors: x
    (B,T,H,P), dt (B,T,H) and A (H,) float32, Bm/Cm (B,T,N) in x's dtype
    (float32 or bfloat16), T a multiple of ``chunk``, P, N and chunk
    multiples of 16 within :data:`MAX_P`, :data:`MAX_N`, :data:`MAX_CHUNK`,
    last dimensions contiguous, all on one CUDA device; bfloat16 x, Bm and
    Cm 16-B aligned with strides in multiples of 8 elements."""
    if x.dim() != 4:
        raise ValueError("x must be (B, T, H, P)")
    Bsz, T, H, P = x.shape
    if dt.shape != (Bsz, T, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} must be (B, T, H) and A "
                         f"{tuple(A.shape)} (H,) for x {tuple(x.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (Bsz, T) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} "
                         f"must be (B, T, N) for x {tuple(x.shape)}")
    N = Bm.shape[2]
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm and Cm must share one dtype of float32 or "
                         f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("dt and A must be float32")
    if chunk <= 0 or chunk % 16 or chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes multiples of 16 "
                         f"up to {MAX_CHUNK}")
    if T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}: pad T "
                         "first")
    if P % 16 or not 0 < P <= MAX_P:
        raise ValueError(f"head dim P={P}: the kernel takes multiples of 16 "
                         f"up to {MAX_P}")
    if N % 16 or not 0 < N <= MAX_N:
        raise ValueError(f"state size N={N}: the kernel takes multiples of "
                         f"16 up to {MAX_N}")
    if Bsz > 65535 or T > 2 ** 31 - 1:
        raise ValueError("a dimension is too large for the kernel's grid")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        # the tensor-core kernel loads rows with 16-B cp.async copies
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1])):
            raise ValueError(
                f"bfloat16 {name} must start 16-B aligned with strides in "
                "multiples of 8 elements, got data_ptr % 16 = "
                f"{t.data_ptr() % 16}, strides {tuple(t.stride())}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on x's device, "
                             f"got {t.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,N) on CUDA, B/C shared
    across heads → (y (B,T,H,P), final state (B,H,P,N)), in x's dtype."""
    check_inputs(x, dt, A, Bm, Cm, chunk)
    Bsz, T, H, P = x.shape
    N = Bm.shape[2]
    y = torch.empty((Bsz, T, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    if Bsz == 0 or H == 0:
        return y, state
    if T == 0:
        return y, state.zero_()
    lib = LIB.lib()
    strides = (ctypes.c_int64 * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    with torch.cuda.device(x.device):
        err = lib.ssd_forward(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                              Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                              state.data_ptr(), _DTYPES[x.dtype], Bsz, T, H,
                              P, N, int(chunk), strides, stream())
    raise_on(err, "ssd_scan")
    count_launch(LAUNCHES, "ssd_scan")
    return y, state
