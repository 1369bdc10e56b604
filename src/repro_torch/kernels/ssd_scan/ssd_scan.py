"""Hand-written CUDA chunked SSD (Mamba-2) for Hopper, forward and
backward, and their launchers.

The forward is the port of the Pallas TPU kernel in the JAX package's
``kernels/ssd_scan/ssd_scan.py``: per (batch, head), the chunks of length
``chunk`` in order, the intra-chunk quadratic form, the inter-chunk term
from the carried (P, N) state, and the state update; zero initial state.
The backward has no TPU counterpart (the reference trains by
differentiating the jnp ``ssd_scan_ref``): it recomputes the states
entering each chunk, carries the state's cotangent back from the final
state's, and computes the five gradients chunk by chunk.  The kernels live
in ``csrc/ssd_scan.cu`` and ``csrc/ssd_scan_bwd.cu`` (design notes there)
and are built at first use (:data:`LIB`, :data:`LIB_BWD`, see
:mod:`.._build`): the dtype picks one — bfloat16 runs on the tensor cores
(the forward on ``mma.sync``, rounding W, x·w and the state operand to
bfloat16; the backward rounds gy·exp(cs), the carried states and the
decay-weighted tiles, and its states, row and column launches run on
``wgmma`` fed by TMA where :func:`backward_route` says so), float32 on the
CUDA cores in full float32.

:func:`ssd_scan` and :func:`ssd_scan_backward` take CUDA tensors only.
They read x, dt, B and C through their strides (the last dimension
contiguous), so the model's slices of the convolution output cost no copy.
They raise ``ValueError`` on what the kernels do not take and count their
launches in :data:`LAUNCHES` and :data:`BWD_LAUNCHES`.  The plain versions
are in :mod:`.ref`; :mod:`.ops` picks between the two by device.
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

#: launches of the forward kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}
#: calls of the backward kernels (one :func:`ssd_scan_backward`) since the
#: last :func:`reset_launches`
BWD_LAUNCHES: Dict[str, int] = {"ssd_scan_bwd": 0}
#: backward passes through the plain twin's VJP since the last
#: :func:`reset_launches`: none on any path since the backward kernel, so
#: every count reads 0 (the training checks assert it)
RECOMPUTES: Dict[str, int] = {"ssd_scan": 0}
#: CTAs the first row and column passes (the ``"tiles"`` route) aim for: the
#: heads of a chunk are split into groups until (batch rows x chunks x
#: tiles x groups) reaches two waves over the H100's 132 SMs (the passes'
#: shared memory holds one CTA an SM)
GROUP_CTAS = 264
#: CTAs one wave of the ``"wgmma"`` route's passes holds: one a streaming
#: multiprocessor of the H100 (their shared memory holds one)
WAVE_CTAS = 132
#: a ``"wgmma"`` CTA's fixed work (its G tiles, its kept tiles' loads, the
#: ring's fill), in heads' worth of pairs: an estimate, not tuned on the
#: card.  It matters where (batch rows x chunks x folds) is under half a
#: wave or leaves a ragged last one; at mamba2's training shape (128 CTAs)
#: and phase 6's table shape (256) every value gives one group
WAVE_CTA_HEADS = 2
#: the ``"wgmma"`` route's tile rows (one wgmma M) and the head dim and
#: state sizes its tensor maps describe
WG_TILE, WG_P, WG_N = 64, 64, (64, 128)


def reset_launches() -> None:
    reset_counts(LAUNCHES, BWD_LAUNCHES, RECOMPUTES)


def _declare(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_forward.argtypes = [p, p, p, p, p, p, p, i32, i32, i32, i32, i32,
                                i32, i32, p, p]
    lib.ssd_forward.restype = i32


def _declare_bwd(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_backward_scratch.argtypes = [i32] * 8
    lib.ssd_backward_scratch.restype = ctypes.c_int64
    lib.ssd_backward.argtypes = [p] * 13 + [i32] * 9 + [p, p]
    lib.ssd_backward.restype = i32


_CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary("ssd_scan", _CSRC / "ssd_scan.cu", _declare)
LIB_BWD = CudaLibrary("ssd_scan_bwd", _CSRC / "ssd_scan_bwd.cu",
                      _declare_bwd,
                      deps=[_CSRC.parents[1] / "csrc" / "hopper.cuh"])


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


def kernel_tile(chunk: int) -> int:
    """Rows of the kernels' tiles for a chunk length (``TL`` in the
    sources)."""
    return 64 if chunk % 64 == 0 else (32 if chunk % 32 == 0 else 16)


#: the backward's routes (``ssd_backward``'s ``route``)
ROUTES = {"tiles": 0, "wgmma": 1}


def backward_route(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """Which states, row and column launches the backward runs:
    ``"wgmma"`` (``bwd_wgstates``, ``bwd_wgrows``, ``bwd_wgcols``:
    warpgroup products fed by TMA, for bfloat16 at P = 64, N = 64 or 128
    and chunks a multiple of 64, the boxes their tensor maps describe; the
    launcher's checks already hold x, B and C to 16-B aligned rows) or
    ``"tiles"`` (the first design's ``mma.sync`` and float32 launches,
    every other shape the kernels take).  The shapes and the dtype decide;
    nothing falls back at run time."""
    if (dtype == torch.bfloat16 and P == WG_P and N in WG_N
            and chunk % WG_TILE == 0):
        return "wgmma"
    return "tiles"


def head_groups(Bsz: int, T: int, H: int, chunk: int, route: str) -> int:
    """The head groups the backward splits each chunk's heads into, as
    equal as whole heads allow; the shapes decide, so the sums' order, and
    the bits, do not change between calls.  ``"tiles"``: the fewest that
    give its passes :data:`GROUP_CTAS` CTAs.  ``"wgmma"``: a CTA a (fold,
    chunk, batch row, group), each taking a group's heads in turn, so the
    passes take (waves of :data:`WAVE_CTAS` CTAs) x (heads a group +
    :data:`WAVE_CTA_HEADS`); the fewest groups that make that least."""
    if route == "wgmma":
        items = max(1, Bsz * (T // chunk) * wgmma_folds(chunk))
        cost = [-(-items * g // WAVE_CTAS) * (-(-H // g) + WAVE_CTA_HEADS)
                for g in range(1, H + 1)]
        want = cost.index(min(cost)) + 1
    else:
        ctas = max(1, Bsz * (T // chunk) * (chunk // kernel_tile(chunk)))
        want = min(H, max(1, -(-GROUP_CTAS // ctas)))
    per = -(-H // want)
    return -(-H // per)


def wgmma_folds(chunk: int) -> int:
    """CTAs a (chunk, batch row, head group) on the ``"wgmma"`` route: fold
    f takes tiles f and nt - 1 - f of the chunk's nt, so that every fold
    does nt + 1 tile pairs (the middle tile of an odd nt alone: (nt + 1) /
    2)."""
    return (chunk // WG_TILE + 1) // 2


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and 16-B aligned (a copy only where it is not)."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor, gy: torch.Tensor,
                      gstate: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_scan` on CUDA: from the forward's inputs
    (as :func:`check_inputs` takes them), y's cotangent ``gy`` (B,T,H,P)
    and the final state's ``gstate`` (B,H,P,N) → (dx (B,T,H,P), ddt
    (B,T,H), dA (H,), dB (B,T,N), dC (B,T,N)); dx, dB and dC contiguous in
    x's dtype, ddt and dA float32.  One call launches the backward's six
    kernels in order on the current stream, those of
    :func:`backward_route`."""
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError("x must be (B, T, H, P) and Bm (B, T, N)")
    Bsz, T, H, P = x.shape
    N = Bm.shape[2]
    if gy.shape != x.shape or gstate.shape != (Bsz, H, P, N):
        raise ValueError(f"gy {tuple(gy.shape)} must be x's shape and "
                         f"gstate {tuple(gstate.shape)} (B, H, P, N) = "
                         f"{(Bsz, H, P, N)}")
    check_inputs(x, dt, A, Bm, Cm, chunk)
    for name, t in (("gy", gy), ("gstate", gstate)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on x's device {x.device}, "
                             f"got {t.device}")
    if T // chunk > 65535:
        raise ValueError(f"{T // chunk} chunks: the backward's grid takes "
                         "at most 65535")
    dev, dtype = x.device, x.dtype
    dx = torch.empty((Bsz, T, H, P), dtype=dtype, device=dev)
    ddt = torch.empty((Bsz, T, H), dtype=torch.float32, device=dev)
    dA = torch.zeros((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((Bsz, T, N), dtype=dtype, device=dev)
    dC = torch.empty((Bsz, T, N), dtype=dtype, device=dev)
    if Bsz == 0 or H == 0 or T == 0:
        return dx, ddt, dA, dB, dC
    route = backward_route(dtype, P, N, chunk)
    groups = head_groups(Bsz, T, H, chunk, route)
    if Bsz * groups > 65535:
        raise ValueError(f"{Bsz} batch rows x {groups} head groups: the "
                         "backward's grid takes at most 65535")
    gy = _dense(gy.to(dtype))
    gstate = _dense(gstate.to(dtype))
    lib = LIB_BWD.lib()
    scratch = torch.empty(
        lib.ssd_backward_scratch(Bsz, T, H, P, N, int(chunk), groups,
                                 ROUTES[route]),
        dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    with torch.cuda.device(dev):
        err = lib.ssd_backward(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), gy.data_ptr(), gstate.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scratch.data_ptr(), _DTYPES[dtype], Bsz, T, H, P, N, int(chunk),
            groups, ROUTES[route], strides, stream())
    raise_on(err, "ssd_scan_backward")
    count_launch(BWD_LAUNCHES, "ssd_scan_bwd")
    return dx, ddt, dA, dB, dC
