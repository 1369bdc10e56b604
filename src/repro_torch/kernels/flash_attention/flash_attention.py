"""Hand-written CUDA flash attention for Hopper, and its launcher.

The port of the Pallas TPU kernel in the JAX package's
``kernels/flash_attention/flash_attention.py``: online-softmax attention
with GQA, causal tile skipping, a sliding window, a tanh softcap and the kv
tail masked.  The kernels live in ``csrc/flash_attention.cu`` (design notes
there) and are built at first use (:data:`LIB`, see :mod:`.._build`): the
dtype picks one — bfloat16 runs on the tensor cores (``mma.sync``, P
rounded to bfloat16 before P·V), float32 on the CUDA cores in full float32.

:func:`flash_attention` takes CUDA tensors only.  It reads q, k and v
through their strides (the last dimension contiguous), so the model's
(B, S, H, hd) projections viewed as (B, H, S, hd) cost no copy, and it
writes the output into a (B, S, H, hd) buffer, returned as its
(B, H, S, hd) view.  It raises ``ValueError`` on what the kernel does not
take and counts its launches in :data:`LAUNCHES`.  The plain version is in
:mod:`.ref`; :mod:`.ops` picks between the two by device.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional

import torch

from .._build import (CudaLibrary, count_launch, raise_on, reset_counts,
                      stream)

#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows, heads and batch rows index the grid and the positions as int32
MAX_DIM = 2 ** 31 - 1

#: launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
#: backward passes since the last :func:`reset_launches`, each one the
#: plain twin's VJP recomputed from the saved inputs (:mod:`.ops`)
RECOMPUTES: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES, RECOMPUTES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_forward.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, i32, i32,
                               p, f32, i32, i32, f32, p]
    lib.fa_forward.restype = i32


LIB = CudaLibrary("flash_attention",
                  Path(__file__).resolve().parent / "csrc"
                  / "flash_attention.cu", _declare)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors: 4-D,
    one dtype (float32 or bfloat16), k and v of one shape, the batch and
    head dims matching, KV dividing H, hd in :data:`HEAD_DIMS` and
    contiguous, all on one CUDA device; bfloat16 tensors 16-B aligned with
    (b, h, s) strides in multiples of 8 elements."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (B, H, S, hd)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B, KV, Skv, hd) for q {tuple(q.shape)}")
    KV = k.shape[1]
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{KV} kv heads do not divide {H} query heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if max(q.shape + k.shape) > MAX_DIM or B > 65535 or H > 65535:
        raise ValueError("a dimension is too large for the kernel's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        # the tensor-core kernel loads rows with 16-B cp.async copies
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(
                f"bfloat16 {name} must start 16-B aligned with (b, h, s) "
                "strides in multiples of 8 elements, got data_ptr % 16 = "
                f"{t.data_ptr() % 16}, strides {tuple(t.stride())}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, KV, Skv, hd) on CUDA, KV divides H →
    (B, H, Sq, hd) in q's dtype, a view of a (B, Sq, H, hd) buffer."""
    check_inputs(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    view = out.transpose(1, 2)
    if B == 0 or Sq == 0 or H == 0:
        return view
    lib = LIB.lib()
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        view.stride(0), view.stride(1), view.stride(2))
    with torch.cuda.device(q.device):
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq,
                             Skv, hd, strides, float(scale), int(causal),
                             int(window) if window is not None else 0,
                             float(softcap), stream())
    raise_on(err, "flash_attention")
    count_launch(LAUNCHES, "flash_attention")
    return view
