"""Per-device totals of one traced step: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

The reference reads its totals off XLA's optimized, SPMD-partitioned HLO
text (loop-aware: a scanned layer's body times its trip count).  The port
has no HLO to parse: the dry run runs the step eagerly on ``meta``
tensors over a ``DeviceMesh``, and :class:`OpCounter`, a
``TorchDispatchMode``, sees every op one rank runs on its local shards,
after ``DTensor`` has turned the global op into local ops and collectives
(the mode declines ``DTensor`` arguments, so DTensor runs first; the ops
DTensor runs on fake tensors to propagate shapes are not counted).  A
Python loop over layers runs every layer, so there are no trip counts to
recover.  It totals, per device:

* ``flops``            — 2·M·N·K for every ``mm``, ``addmm``, ``bmm`` and
                         ``baddbmm``, plus each kernel custom op's own
                         count (``kernels/cost.py``, the formulas of
                         ``chip_smoke.py``'s bounds);
* ``hbm_bytes``        — Σ (input + output bytes) of every op that moves
                         data (views and allocations move none).  Eager
                         torch fuses nothing, so this is an upper bound on
                         HBM traffic, not XLA's fusion-boundary count;
* ``collectives``      — count and result bytes per collective kind, and
                         in :attr:`Totals.by_axis` per kind and mesh axis
                         (DTensor's own resharding all-to-all included);
* ``peak_bytes``       — the peak of live bytes the step allocated (its
                         temporaries; inputs held before it are not in it).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.cost import (flash_attention_bwd_cost, flash_attention_cost,
                            flash_decode_cost, ssd_scan_bwd_cost,
                            ssd_scan_cost)
from ..kernels.flash_attention.flash_decode import key_range

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: (namespace, op) → the reference's collective kind: the functional
#: collectives, and DTensor's own all-to-all for moving a shard to another
#: dim (whose meta kernel calls no collective)
_COLLECTIVES = {
    **{("_c10d_functional", op): kind for op, kind in (
        ("all_reduce", "all-reduce"), ("all_reduce_", "all-reduce"),
        ("all_reduce_coalesced", "all-reduce"),
        ("all_gather_into_tensor", "all-gather"),
        ("all_gather_into_tensor_coalesced", "all-gather"),
        ("reduce_scatter_tensor", "reduce-scatter"),
        ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
        ("all_to_all_single", "all-to-all"),
        ("broadcast", "collective-permute"))},
    ("_dtensor", "shard_dim_alltoall"): "all-to-all"}

_aten = torch.ops.aten
#: ops that allocate and move no data
_ALLOC = {_aten.empty.memory_format, _aten.empty_strided.default,
          _aten.empty_like.default, _aten.new_empty.default,
          _aten.new_empty_strided.default}
#: ops that alias their input (besides views) and move no data
_ALIAS = {_aten._unsafe_view.default, _aten.detach.default,
          _aten.alias.default, _aten.lift_fresh.default}


@dataclass
class Totals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: mesh axis → kind → {"count", "bytes"}
    by_axis: Dict[str, Dict[str, Dict[str, float]]] = field(
        default_factory=dict)
    #: collective op (``all_to_all_single``, DTensor's
    #: ``shard_dim_alltoall``, ...) → calls
    collective_ops: Dict[str, int] = field(default_factory=dict)
    #: kernel custom op → calls
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    peak_bytes: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return sum(v["bytes"] for v in self.collectives.values())

    def axis_bytes(self) -> Dict[str, float]:
        return {a: sum(v["bytes"] for v in kinds.values())
                for a, kinds in self.by_axis.items()}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _mm_flops(func, args) -> float:
    if func in (_aten.mm.default, _aten.bmm.default):
        a, b = args[0], args[1]
    elif func in (_aten.addmm.default, _aten.baddbmm.default):
        a, b = args[1], args[2]
    else:
        return 0.0
    batch = a.shape[0] if a.dim() == 3 else 1
    M, K = a.shape[-2], a.shape[-1]
    return 2.0 * batch * M * K * b.shape[-1]


def _kernel_cost(name: str, args) -> tuple:
    """(FLOPs, bytes) of one call of the ``repro_torch`` kernel op
    ``name``, by its formula in ``kernels/cost.py``; an op without one
    raises."""
    if name in ("flash_attention", "flash_attention_lse",
                "flash_attention_backward"):
        q, k = args[0], args[1]
        B, H, Sq, hd = q.shape
        shape = (B, H, k.shape[1], Sq, k.shape[2], hd)
        if name == "flash_attention_backward":
            return flash_attention_bwd_cost(*shape, args[6], args[7],
                                            q.element_size())
        return flash_attention_cost(*shape, args[3], args[4],
                                    q.element_size(),
                                    lse=name == "flash_attention_lse")
    if name == "flash_decode":
        q, k, v = args[0], args[1], args[2]
        kv_len, window, q_offset, causal = args[3], args[4], args[6], args[8]
        lo, hi = key_range(k.shape[1], kv_len, causal, window, q_offset)
        return flash_decode_cost(q.shape[0], q.shape[2], k.shape[2],
                                 max(0, hi - lo), q.shape[3], v.shape[3],
                                 q.element_size())
    if name in ("ssd_scan", "ssd_scan_backward"):
        x, dt, Bm = args[0], args[1], args[3]
        B, T, H, P = x.shape
        if name == "ssd_scan_backward":
            return ssd_scan_bwd_cost(B, T, H, P, Bm.shape[-1], args[7],
                                     x.element_size(), dt.element_size())
        return ssd_scan_cost(B, T, H, P, Bm.shape[-1], args[5],
                             x.element_size(), dt.element_size())
    raise KeyError(f"no cost formula for the kernel op repro_torch::{name}")


class OpCounter(TorchDispatchMode):
    """Totals of the local ops run under it (see the module docstring).
    ``axes`` maps a process group's name to the mesh axis it spans
    (:func:`axes_of`); collectives over other groups count under their
    group's name."""

    def __init__(self, axes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.totals = Totals()
        self.axes = dict(axes or {})
        self._live = 0

    def _free(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # let DTensor desugar it first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                       # DTensor's shape propagation
        t = self.totals
        ns = func.namespace
        name = func._overloadpacket.__name__
        if (ns, name) in _COLLECTIVES:
            kind = _COLLECTIVES[ns, name]
            nb = float(sum(_nbytes(o) for o in outs))
            group = args[-1] if args else kwargs.get("group_name", "")
            group = getattr(group, "group_name", group)
            axis = self.axes.get(group, group)
            for table in (t.collectives,
                          t.by_axis.setdefault(axis, {})):
                rec = table.setdefault(kind, {"count": 0.0, "bytes": 0.0})
                rec["count"] += 1
                rec["bytes"] += nb
            t.collective_ops[name] = t.collective_ops.get(name, 0) + 1
        elif ns == "repro_torch":
            flops, nb = _kernel_cost(name, args)
            t.flops += flops
            t.hbm_bytes += nb
            t.kernel_calls[name] = t.kernel_calls.get(name, 0) + 1
            self._track(outs, ins)
            return out
        else:
            t.flops += _mm_flops(func, args)
        if func in _ALLOC:
            self._track(outs, ins)
            return out
        if func.is_view or func in _ALIAS or name == "wait_tensor":
            return out
        t.hbm_bytes += float(sum(_nbytes(x) for x in ins + outs))
        self._track(outs, ins)
        return out

    def _track(self, outs, ins) -> None:
        """Count fresh outputs as live until their tensors die."""
        for o in outs:
            if any(o is i for i in ins) or o._is_view():
                continue
            n = _nbytes(o)
            self._live += n
            weakref.finalize(o, self._free, n)
        self.totals.peak_bytes = max(self.totals.peak_bytes, self._live)


def axes_of(mesh) -> Dict[str, str]:
    """{process group name: mesh axis} of a ``DeviceMesh``."""
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


def count(fn, *args, mesh=None, **kwargs):
    """(fn's result, the :class:`Totals` of running it)."""
    with OpCounter(axes_of(mesh) if mesh is not None else None) as c:
        out = fn(*args, **kwargs)
    return out, c.totals
