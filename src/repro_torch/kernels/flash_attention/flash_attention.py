"""Hand-written CUDA flash attention for Hopper, forward and backward, and
their launchers.

The forward is the port of the Pallas TPU kernel in the JAX package's
``kernels/flash_attention/flash_attention.py``: online-softmax attention
with GQA, causal tile skipping, a sliding window, a tanh softcap and the kv
tail masked.  The backward has no TPU counterpart (the reference trains
through jnp attention): it recomputes P tile by tile from the forward's
row log-sum-exp.  The kernels live in ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` (design notes there) and are built at
first use (:data:`LIB`, :data:`LIB_BWD`, see :mod:`.._build`): the dtype
picks one — bfloat16 runs on the tensor cores (P, and in the backward dS,
rounded to bfloat16 before their products), float32 on the CUDA cores in
full float32.  The bf16 backward up to head dim 256 is one fused
``wgmma``/TMA kernel between a D pass and a dq pass: persistent CTAs
claim kv tiles, compute S and dP once a (q, k) pair, and add dq's shares
into a float32 sum in ascending kv-tile order (:func:`backward_scratch`),
so two calls give the same bits; above 256 it is the FlashAttention-2
split on ``mma.sync``, one launch a slice of columns.

:func:`flash_attention` and :func:`flash_attention_backward` take CUDA
tensors only.  They read their inputs through their strides (the last
dimension contiguous), so the model's (B, S, H, hd) projections viewed as
(B, H, S, hd) cost no copy, and write each output into a (B, S, heads, hd)
buffer, returned as its (B, heads, S, hd) view.  The head dim is one the
kernels are built for (:data:`HEAD_DIMS`) or, above 256, any multiple of
32, which the launchers split into slices of built widths.  They raise
``ValueError`` on what the kernels do not take and count their launches in
:data:`LAUNCHES`.  The plain versions are in :mod:`.ref`; :mod:`.ops`
picks between the two by device.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .._build import (CudaLibrary, count_launch, raise_on, reset_counts,
                      stream)

#: head dims the kernels are instantiated for; above the largest, any
#: multiple of 32 runs as slices of these
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows, heads and batch rows index the grid and the positions as int32
MAX_DIM = 2 ** 31 - 1

#: launches since the last :func:`reset_launches`: the forward kernel and
#: the backward kernels (one call of :func:`flash_attention_backward`)
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
#: backward passes through the plain twin's VJP since the last
#: :func:`reset_launches`: none on any path since the backward kernel, so
#: every count reads 0 (the training checks assert it)
RECOMPUTES: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES, RECOMPUTES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_forward.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, i32,
                               i32, p, f32, i32, i32, f32, p]
    lib.fa_forward.restype = i32


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_backward.argtypes = [p] * 12 + [i32] * 7 + [p, f32, i32, i32,
                                                       f32, p]
    lib.fa_backward.restype = i32


_CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary("flash_attention", _CSRC / "flash_attention.cu", _declare,
                  deps=[_CSRC / "fa_common.cuh"])
LIB_BWD = CudaLibrary("flash_attention_bwd", _CSRC / "flash_attention_bwd.cu",
                      _declare_bwd, deps=[_CSRC / "fa_common.cuh",
                                          _CSRC.parents[1] / "csrc"
                                          / "hopper.cuh"])

#: q rows of a backward q tile; the fused bf16 kernel's widest head dim
BWD_Q_TILE, FUSED_MAX_HD = 64, 256


def backward_scratch(dtype: torch.dtype, B: int, H: int, Sq: int,
                     hd: int) -> Tuple[int, int, int]:
    """Elements of the backward's float32 ``delta`` and ``acc`` and its
    int32 ``counters`` (``csrc/flash_attention_bwd.cu`` ``fa_backward``,
    whose first pass zeroes ``acc`` and ``counters``).  The fused bf16 kernel (head dims up to 256) takes
    lse' and D padded to whole 64-row q tiles, dq's float32 sum a (b, h, q
    tile) at the head dim padded to 64, one counter a (b, h, q tile) and
    the kv tiles' claim counter; otherwise D alone."""
    if dtype == torch.bfloat16 and hd <= FUSED_MAX_HD:
        rows = B * H * -(-Sq // BWD_Q_TILE) * BWD_Q_TILE
        return 2 * rows, rows * max(hd, 64), 1 + rows // BWD_Q_TILE
    return B * H * Sq, 0, 0


def kernel_takes_head_dim(hd: int) -> bool:
    """Whether the kernels take head dim ``hd``: a built one, or above 256
    a multiple of 32 (a sum of built widths, one launch a slice)."""
    return hd in HEAD_DIMS or (hd > HEAD_DIMS[-1] and hd % 32 == 0)


def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s last dimension must be contiguous")
    # the tensor-core kernels load rows with 16-B cp.async copies
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
        raise ValueError(
            f"bfloat16 {name} must start 16-B aligned with (b, h, s) "
            "strides in multiples of 8 elements, got data_ptr % 16 = "
            f"{t.data_ptr() % 16}, strides {tuple(t.stride())}")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernels take these tensors: 4-D,
    one dtype (float32 or bfloat16), k and v of one shape, the batch and
    head dims matching, KV dividing H, a head dim of
    :func:`kernel_takes_head_dim` and contiguous, all on one CUDA device;
    bfloat16 tensors 16-B aligned with (b, h, s) strides in multiples of 8
    elements."""
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
    if not kernel_takes_head_dim(hd):
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS} and "
                         f"multiples of 32 above {HEAD_DIMS[-1]}")
    if max(q.shape + k.shape) > MAX_DIM or B > 65535 or H > 65535:
        raise ValueError("a dimension is too large for the kernel's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")


def _strides(*views: torch.Tensor):
    return (ctypes.c_int64 * (3 * len(views)))(
        *[st for t in views for st in t.stride()[:3]])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    return_lse: bool = False):
    """q: (B, H, Sq, hd); k/v: (B, KV, Skv, hd) on CUDA, KV divides H →
    (B, H, Sq, hd) in q's dtype, a view of a (B, Sq, H, hd) buffer; with
    ``return_lse``, also each row's log-sum-exp of the scaled (softcapped,
    masked) scores, float32 (B, H, Sq), which the backward takes."""
    check_inputs(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    view = out.transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or Sq == 0 or H == 0:
        return (view, lse) if return_lse else view
    lib = LIB.lib()
    with torch.cuda.device(q.device):
        err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(),
                             lse.data_ptr() if return_lse else None,
                             _DTYPES[q.dtype], B, H, KV, Sq, Skv, hd,
                             _strides(q, k, v, view), float(scale),
                             int(causal),
                             int(window) if window is not None else 0,
                             float(softcap), stream())
    raise_on(err, "flash_attention")
    count_launch(LAUNCHES, "flash_attention")
    return (view, lse) if return_lse else view


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels read it in place, else a contiguous copy (a
    cotangent autograd hands over may be expanded or arbitrarily
    strided)."""
    try:
        _check_layout("t", t)
        return t
    except ValueError:
        return t.contiguous()


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             softcap: float = 0.0,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradient of :func:`flash_attention` at q, k, v: ``out`` and
    ``lse`` its forward's (``return_lse=True``), ``dout`` the output's
    cotangent → (dq, dk, dv) in q's dtype, views (B, heads, S, hd) of
    (B, S, heads, hd) buffers.  One launch of the backward kernels."""
    check_inputs(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be like q {tuple(q.shape)} "
                             f"{q.dtype}, got {tuple(t.shape)} {t.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(B, H, Sq)} on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out, dout = _kernel_layout(out), _kernel_layout(dout)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dq = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, KV, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    views = dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    if B == 0 or H == 0 or Skv == 0:
        return views
    if Sq == 0:
        return views[0], dk.zero_().transpose(1, 2), \
            dv.zero_().transpose(1, 2)
    # one allocation: delta and acc (16-B aligned: delta's length is a
    # multiple of 4), then the int32 counters
    n_delta, n_acc, n_counters = backward_scratch(q.dtype, B, H, Sq, hd)
    work = torch.empty(n_delta + n_acc + n_counters, dtype=torch.float32,
                       device=q.device)
    delta, acc = work[:n_delta], work[n_delta:n_delta + n_acc]
    counters = work[n_delta + n_acc:].view(torch.int32)
    lib = LIB_BWD.lib()
    with torch.cuda.device(q.device):
        err = lib.fa_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), acc.data_ptr(),
            counters.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Skv, hd,
            _strides(q, k, v, out, dout, *views), float(scale),
            int(causal), int(window) if window is not None else 0,
            float(softcap), stream())
    raise_on(err, "flash_attention_backward")
    count_launch(LAUNCHES, "flash_attention_bwd")
    return views
