"""The work of the LM kernels: FLOPs and the bytes they must move.

One place for the formulas that ``chip_smoke.py`` phases 5, 6 and 14 use
for the kernels' bounds and that the dry run's counting mode
(``launch/op_analysis.py``) charges for each call of a kernel's custom op.
FLOPs count 2 a multiply-add over the work the masks keep; bytes count
each input read once and each output written once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def attention_pairs(Sq: int, Skv: int, causal: bool,
                    window: Optional[int]) -> int:
    """The (query, key) pairs a mask keeps, queries at positions
    0..Sq-1."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q + 1, Skv) if causal else np.full(Sq, Skv, np.int64)
    lo = np.maximum(0, q - window + 1) if window is not None \
        else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo).sum())


def flash_attention_cost(B: int, H: int, KV: int, Sq: int, Skv: int,
                         hd: int, causal: bool, window: Optional[int],
                         itemsize: int, lse: bool = False
                         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash-attention forward: QK^T and PV over the
    kept pairs of every (batch row, head); q, k, v read and out written
    (with ``lse``, the float32 row log-sum-exp written too)."""
    flops = 4.0 * hd * attention_pairs(Sq, Skv, causal, window) * B * H
    nbytes = float(itemsize * (2 * B * H * Sq * hd + 2 * B * KV * Skv * hd)
                   + (4 * B * H * Sq if lse else 0))
    return flops, nbytes


def flash_attention_bwd_cost(B: int, H: int, KV: int, Sq: int, Skv: int,
                             hd: int, causal: bool, window: Optional[int],
                             itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash-attention backward: 10·hd FLOPs a kept
    pair (the recomputed S, dP, dV, dQ and dK, 2 a multiply-add each) of
    every (batch row, head); q, k, v, out, dout and the float32 lse read,
    dq, dk and dv written."""
    flops = 10.0 * hd * attention_pairs(Sq, Skv, causal, window) * B * H
    q_like, kv_like = B * H * Sq * hd, B * KV * Skv * hd
    nbytes = float(itemsize * (3 * q_like + 2 * kv_like)     # q, out, dout
                   + 4 * B * H * Sq                          # lse
                   + itemsize * (q_like + 2 * kv_like))      # dq, dk, dv
    return flops, nbytes


def flash_decode_cost(B: int, H: int, KV: int, n_keys: int, hd: int,
                      vd: int, itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention call: one query a (batch row,
    head) over ``n_keys`` attended keys, q·k and p·v; q read, the attended
    K and V rows read once for all the heads of their group, out
    written."""
    flops = 2.0 * B * H * n_keys * (hd + vd)
    nbytes = float(itemsize * (B * H * hd + B * KV * n_keys * (hd + vd)
                               + B * H * vd))
    return flops, nbytes


def ssd_scan_cost(B: int, T: int, H: int, P: int, N: int, L: int,
                  itemsize: int, dt_itemsize: int = 4
                  ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one chunked SSD scan with chunk ``L``.  Causal
    work: C B^T's lower triangle once per (batch row, chunk), shared by
    the heads; per head W·x over the triangle, C·state^T and the state
    update.  Bytes: x, B, C (``itemsize``), dt and A (``dt_itemsize``)
    read; y and the final state written."""
    nc = T // L
    tri = L * (L + 1) / 2
    flops = 2.0 * (B * nc * tri * N
                   + B * H * nc * (tri * P + L * N * P + P * N * L))
    nbytes = float(itemsize * B * T * H * P          # x in
                   + itemsize * 2 * B * T * N        # B and C in
                   + dt_itemsize * (B * T * H + H)   # dt and A
                   + itemsize * B * T * H * P        # y out
                   + itemsize * B * H * P * N)       # final state out
    return flops, nbytes


def ssd_scan_bwd_cost(B: int, T: int, H: int, P: int, N: int, L: int,
                      itemsize: int, dt_itemsize: int = 4
                      ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one chunked SSD backward with chunk ``L``: the
    products of its formulas (``csrc/ssd_scan_bwd.cu``) over the causal
    triangles.  Per (batch row, chunk) C B^T's lower triangle once,
    shared by the heads; per head M = gy x^T, dx's (G D dt)^T gy, dC's
    (M D dt) B and dB's (M D dt)^T C over the triangle, and five (L, P, N)
    products: dx's B dh^T, dB's x dh, dC's gy h, the chunk's own state and
    its own cotangent (the states recomputed).  Bytes: x, gy, B, C and
    gstate (``itemsize``), dt and A (``dt_itemsize``) read; dx, dB, dC
    (``itemsize``), ddt and dA (``dt_itemsize``) written."""
    nc = T // L
    tri = L * (L + 1) / 2
    flops = 2.0 * (B * nc * tri * N
                   + B * H * nc * (2 * tri * P + 2 * tri * N
                                   + 5 * L * P * N))
    nbytes = float(itemsize * (3 * B * T * H * P       # x, gy in; dx out
                               + 4 * B * T * N         # B, C in; dB, dC out
                               + B * H * P * N)        # gstate in
                   + dt_itemsize * 2 * (B * T * H + H))  # dt, A in; ddt, dA
    return flops, nbytes
