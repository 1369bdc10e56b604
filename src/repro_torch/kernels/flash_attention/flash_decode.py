"""Hand-written CUDA decode attention for Hopper and its launcher.

One query a (batch row, head) over a KV cache read in place: the attention
of every cached decode step on the card.  It replaces no Pallas kernel —
the reference decodes through jnp ``sdpa`` — and computes the function of
the port's plain twin ``models/layers.flash_decode`` (the kernel and its
design are in ``csrc/flash_decode.cu``): q scaled in its own type, float32
scores and online softmax, p rounded to v's type before P·V, float32 sums,
the output in q's type.  It reads the bf16, fp16 or float32 cache once, with
no upcast copy, and is bound by those bytes.

:func:`flash_decode` takes CUDA tensors only, raises ``ValueError`` on what
the kernel does not take and counts its calls in :data:`LAUNCHES` (one a
call, whether it launches one kernel or, with the key range split, a second
that merges the splits).  Masking becomes one range of keys on the host
(:func:`key_range`): ``kv_len``, ``causal``, ``q_offset`` and ``window`` are
host ints, so nothing is read back from the device.  :func:`split_plan`
splits that range for the card's SMs.  :mod:`.ops` wraps the launcher as the
custom op ``repro_torch::flash_decode``, and :func:`kernel_takes` is the
shape, dtype and device test by which ``models/layers._route`` sends a
decode call to it: on CUDA tensors, and on meta tensors, so that the dry
run (``launch/dryrun.py``) counts the route the card takes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from .._build import (CudaLibrary, count_launch, raise_on, reset_counts,
                      stream)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest head dim of q·k and of v the kernel takes
MAX_HEAD_DIM = 256
#: most query heads one CTA serves; a larger group takes several CTAs
HEAD_GROUP = 8
#: the grid covers the SMs at least this many times before a split shrinks
WAVES = 8
#: no split is shorter than this many keys
MIN_SPLIT_KEYS = 256
#: a split's length is a multiple of this: a CTA's keys a step at hd 128
#: (8 slots x 8 keys), so every split starts on the same 64-key grid (at
#: internlm2's decode on one H100, 512-key splits ran 0.104-0.125 ms a
#: call where 483-key splits ran 0.128-0.205 ms)
SPLIT_ALIGN = 64
#: rows and positions index the grid as int32
MAX_DIM = 2 ** 31 - 1

#: calls since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash_decode": 0}


def reset_launches() -> None:
    reset_counts(LAUNCHES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_decode.argtypes = [p] * 6 + [i32] * 6 + [p] + [i32] * 5 + [
        f32, f32, p]
    lib.fa_decode.restype = i32


_CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary("flash_decode", _CSRC / "flash_decode.cu", _declare,
                  deps=[_CSRC / "fa_common.cuh"])


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a call goes to the kernel: one query, on CUDA (or meta, the
    dry run's stand-in for the card), q, k and v of one of its dtypes, head
    dims of q·k and v up to :data:`MAX_HEAD_DIM` and whole 16-byte vectors.
    Shapes, dtypes and the device decide it."""
    if (q.device.type not in ("cuda", "meta") or q.dim() != 4
            or q.shape[1] != 1):
        return False
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        return False
    vec = 16 // q.element_size()
    return all(0 < d <= MAX_HEAD_DIM and d % vec == 0
               for d in (q.shape[-1], v.shape[-1]))


def key_range(Skv: int, kv_len: Optional[int], causal: bool,
              window: Optional[int], q_offset: int) -> Tuple[int, int]:
    """The keys [lo, hi) one query at position ``q_offset`` sees in
    ``layers.sdpa``: below ``kv_len`` (default Skv), at most ``q_offset``
    when causal, and within ``window`` of it.  Every other key scores
    -1e30 there and adds exactly nothing."""
    hi = Skv if kv_len is None else min(int(kv_len), Skv)
    if causal:
        hi = min(hi, q_offset + 1)
    lo = max(0, q_offset - int(window) + 1) if window is not None else 0
    return lo, hi


def split_plan(n_keys: int, ctas: int, sms: int) -> Tuple[int, int]:
    """(splits, keys a split) for ``n_keys`` keys over ``ctas`` CTAs a
    split: enough splits for the grid to cover ``sms`` SMs :data:`WAVES`
    times, none shorter than :data:`MIN_SPLIT_KEYS` (or than the range),
    each a multiple of :data:`SPLIT_ALIGN` keys; equal runs, the last
    shorter."""
    want = max(1, -(-WAVES * sms // ctas))
    per = max(-(-n_keys // want), MIN_SPLIT_KEYS)
    per = min(-(-per // SPLIT_ALIGN) * SPLIT_ALIGN, n_keys)
    return -(-n_keys // per), per


def head_group(G: int) -> int:
    """Query heads a CTA serves: the power of two that holds the group,
    at most :data:`HEAD_GROUP`."""
    gc = 1
    while gc < min(G, HEAD_GROUP):
        gc *= 2
    return gc


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes these tensors:
    :func:`kernel_takes`, k (B, Skv, KV, hd) and v (B, Skv, KV, vd) on q's
    device, KV dividing H, every last dimension contiguous, k and v 16-B
    aligned with strides in whole 16-B vectors (a cache always is)."""
    if k.dim() != 4 or v.dim() != 4 or not kernel_takes(q, k, v):
        raise ValueError(
            f"flash_decode takes q (B, 1, H, hd), k and v 4-D of one dtype of "
            f"{list(_DTYPES)} on CUDA, head dims up to {MAX_HEAD_DIM} in "
            f"whole 16-B vectors; got q {tuple(q.shape)} {q.dtype} on "
            f"{q.device}, k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
            f"{v.dtype}")
    B, _, H, hd = q.shape
    if (k.shape[0] != B or k.shape[3] != hd or v.shape[:3] != k.shape[:3]):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, Skv, KV, ·) for q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV != 0:
        raise ValueError(f"{KV} kv heads do not divide {H} query heads")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.stride(3) != 1:
        raise ValueError("q's last dimension must be contiguous")
    vec = 16 // q.element_size()
    for name, t in (("k", k), ("v", v)):
        # the kernel reads K and V rows in 16-B loads
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(st % vec for st in t.stride()[:3])):
            raise ValueError(
                f"{name} must have a contiguous last dimension, start 16-B "
                f"aligned and have (b, s, h) strides in multiples of {vec} "
                f"elements, got data_ptr % 16 = {t.data_ptr() % 16}, "
                f"strides {tuple(t.stride())}")
    if max(q.shape + k.shape) > MAX_DIM or B > 65535:
        raise ValueError("a dimension is too large for the kernel's grid")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_len: Optional[int] = None, window: Optional[int] = None,
                 attn_softcap: float = 0.0, q_offset: int = 0,
                 scale: Optional[float] = None,
                 causal: bool = True) -> torch.Tensor:
    """q (B, 1, H, hd), k (B, Skv, KV, hd), v (B, Skv, KV, vd) on CUDA →
    (B, 1, H, vd) in q's dtype: ``layers.sdpa``'s decode attention,
    arguments as there.  The caches are read through their strides."""
    check_inputs(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    B, _, H, hd = q.shape
    Skv, KV, vd = k.shape[1], k.shape[2], v.shape[3]
    lo, hi = key_range(Skv, kv_len, causal, window, q_offset)
    if hi <= lo:
        raise ValueError(f"no key is attended: kv_len {kv_len}, q_offset "
                         f"{q_offset}, window {window}, causal {causal}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty((B, 1, H, vd), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    gc = head_group(H // KV)
    ctas = B * KV * -(-(H // KV) // gc)
    splits, chunk = split_plan(hi - lo, ctas, _sm_count(q.device.index))
    part = ml = None
    if splits > 1:
        work = torch.empty(B * H * splits * (vd + 2), dtype=torch.float32,
                           device=q.device)
        part, ml = work[:B * H * splits * vd], work[B * H * splits * vd:]
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(2),
                                   *k.stride()[:3], *v.stride()[:3])
    lib = LIB.lib()
    with torch.cuda.device(q.device):
        err = lib.fa_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            ml.data_ptr() if ml is not None else None, _DTYPES[q.dtype], B,
            H, KV, hd, vd, strides, lo, hi, chunk, splits, gc, float(scale),
            float(attn_softcap), stream())
    raise_on(err, "flash_decode")
    count_launch(LAUNCHES, "flash_decode")
    return out
