"""Graph IR for UDF-centric workloads (paper §2.2.1).

The paper's IR assumption: a workload maps to a DAG where each node is an
*atomic computation* that remains individually executable after compilation
(PlinyCompute lambda-calculus property).  We reproduce that property: every
node carries an executable ``fn`` over torch/numpy values, so any subgraph —
in particular a two-terminal partitioner candidate — can be compiled back
into a key-projection function via :meth:`IRGraph.compile_fn`.

Node categories (paper §2.2.1):
  (1) lambda abstractions     — ``attr:<name>``, ``literal:<v>``, ``func:<u>``,
                                ``parse:<fmt>``, ``opaque:<tag>``
  (2) higher-order composites — ``binop:<op>``, ``cond``
  (3) set-based operators     — ``scan``, ``write``, ``partition``, ``apply``,
                                ``join``, ``aggregate``, ``filter``, ``flatten``

**Value widths.**  A key projection must give the JAX reference's bits,
and the reference runs with 64-bit types off: any operation that touches a
jnp value (a literal, a ``func``, a ``cond``, a device column) computes at
32 bits, while plain numpy columns keep their own widths.  The port keeps
the same split with its own types: numpy arrays stay numpy, and torch
tensors play the jnp values.  An operation on two numpy operands is numpy
arithmetic; as soon as one operand is a torch tensor of at most 32 bits
every operand is brought to 32 bits (int64 wraps to int32, float64 rounds
to float32) and torch computes.  A 64-bit torch tensor — a column of a
device-resident store, which the reference keeps as numpy — computes at
its own width, numpy-style.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..kernels.hash_partition.ref import wang_hash

_WIDE = (torch.int64, torch.float64, torch.complex128)


def _canon(x) -> torch.Tensor:
    """A value as the reference's jnp would hold it: a torch tensor of at
    most 32 bits (int64 wraps, float64 rounds to float32)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.int64:
        return t.to(torch.int32)
    if t.dtype == torch.float64:
        return t.to(torch.float32)
    if t.dtype == torch.complex128:
        return t.to(torch.complex64)
    return t


def _is_narrow_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype not in _WIDE


def _align(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Operands on one device: the first non-CPU one's, else the CPU."""
    dev = next((t.device for t in ts if t.device.type != "cpu"), ts[0].device)
    return tuple(t.to(dev) for t in ts)


def _jnp_op(fn: Callable) -> Callable:
    """An op the reference always computes with jnp: 32 bits, torch."""
    return lambda *xs: fn(*_align(*(_canon(x) for x in xs)))


def _binop(op: str, fn: Callable) -> Callable:
    """An arithmetic/comparison op with the reference's width rules (see
    the module docstring)."""
    def run(a, b):
        if _is_narrow_tensor(a) or _is_narrow_tensor(b):
            return fn(*_align(_canon(a), _canon(b)))
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            # 64-bit operands at their own widths, numpy-style: integer
            # true division gives float64
            a, b = _align(torch.as_tensor(a), torch.as_tensor(b))
            if op == "/" and not (a.is_floating_point()
                                  or b.is_floating_point()):
                a, b = a.to(torch.float64), b.to(torch.float64)
        return fn(a, b)
    return run


# ---------------------------------------------------------------------------
# Atomic-op registry: label prefix -> fn factory.  Mirrors the paper's
# "each atomic computation is executable separately".
# ---------------------------------------------------------------------------

_UNARY_FUNCS: Dict[str, Callable] = {
    "exp": _jnp_op(torch.exp), "log": _jnp_op(torch.log),
    "sqrt": _jnp_op(torch.sqrt), "sin": _jnp_op(torch.sin),
    "cos": _jnp_op(torch.cos), "tan": _jnp_op(torch.tan),
    "abs": _jnp_op(torch.abs), "neg": lambda x: -x,
    "lower": lambda x: x,  # string ops are identity on coded columns
    "hash": lambda x: _mix_hash(x),
}

_BINOPS: Dict[str, Callable] = {
    "==": _binop("==", lambda a, b: a == b),
    "!=": _binop("!=", lambda a, b: a != b),
    "<": _binop("<", lambda a, b: a < b),
    ">": _binop(">", lambda a, b: a > b),
    "<=": _binop("<=", lambda a, b: a <= b),
    ">=": _binop(">=", lambda a, b: a >= b),
    "+": _binop("+", lambda a, b: a + b),
    "-": _binop("-", lambda a, b: a - b),
    "*": _binop("*", lambda a, b: a * b),
    "/": _binop("/", lambda a, b: a / b),
    "%": _binop("%", lambda a, b: a % b),
    "&&": _jnp_op(torch.logical_and),
    "||": _jnp_op(torch.logical_or),
    "&": _binop("&", lambda a, b: a & b),
    "|": _binop("|", lambda a, b: a | b),
}


def _mix_hash(x) -> torch.Tensor:
    """Deterministic 32-bit integer mix (Wang hash) used as the hash lambda.

    Dtype rules of the reference: float32 bits are reinterpreted as int32,
    float64 is rounded to float32 first, int64 wraps to int32, every other
    type is cast to int32.  Returns an int64 tensor holding the uint32 hash.
    """
    t = _canon(x)
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    elif t.dtype == torch.bool or t.is_floating_point() or t.is_complex():
        t = t.to(torch.int32)
    return wang_hash(t)


def resolve_fn(label: str, params: Dict[str, Any]) -> Optional[Callable]:
    """Return the executable callable for an atomic-op label, if any."""
    kind, _, arg = label.partition(":")
    if kind == "scan" or kind == "partition" or kind == "write":
        return lambda x: x
    if kind == "parse":
        # Adaptation: our store is columnar/pre-parsed; parse is structural.
        return lambda x: x
    if kind == "attr":
        name = arg
        return lambda x, _n=name: x[_n] if isinstance(x, dict) else x
    if kind == "index":
        i = int(arg)
        return lambda x, _i=i: x[..., _i]
    if kind == "literal":
        val = params.get("value")
        return lambda *_xs, _v=val: _canon(_v)
    if kind == "func":
        return _UNARY_FUNCS.get(arg)
    if kind == "binop":
        return _BINOPS.get(arg)
    if kind == "cond":
        return _jnp_op(lambda c, t, f: torch.where(c.to(torch.bool), t, f))
    if kind == "opaque":
        return params.get("fn")
    # set-based ops (apply/join/aggregate/filter/flatten) are executed by the
    # executor, not by subgraph compilation.
    return params.get("fn")


# ---------------------------------------------------------------------------
# Nodes and graphs
# ---------------------------------------------------------------------------

SET_OPS = ("scan", "write", "partition", "apply", "join", "aggregate",
           "filter", "flatten")


@dataclass
class Node:
    id: int
    label: str                      # canonical op label, used in signatures
    params: Dict[str, Any] = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.label.partition(":")[0]

    @property
    def is_partition(self) -> bool:
        return self.kind == "partition"

    @property
    def is_scan(self) -> bool:
        return self.kind == "scan"

    @property
    def is_write(self) -> bool:
        return self.kind == "write"

    def signature_token(self) -> str:
        """Label token contributing to path signatures.  Strategy of a
        partition node is part of its identity (paper §2.2.3)."""
        if self.is_partition:
            return f"partition[{self.params.get('strategy', 'hash')}]"
        if self.is_scan:
            # dataset identity is NOT in the token: matching is structural,
            # the same key-projection applies to any dataset read the same way
            return "scan"
        return self.label

    def fn(self) -> Optional[Callable]:
        return resolve_fn(self.label, self.params)


class IRGraph:
    """A DAG IR: ``a = (V, E, S, O)`` per paper §2.2.1."""

    def __init__(self) -> None:
        self.nodes: Dict[int, Node] = {}
        self._children: Dict[int, List[int]] = {}
        self._parents: Dict[int, List[int]] = {}   # ordered (binop arg order)
        self._next_id = 0
        self._sig_cache: Optional[str] = None      # memoized graph_signature

    # -- construction -------------------------------------------------------
    def add_node(self, label: str, params: Optional[Dict[str, Any]] = None) -> int:
        nid = self._next_id
        self._next_id += 1
        self.nodes[nid] = Node(nid, label, dict(params or {}))
        self._children[nid] = []
        self._parents[nid] = []
        self._sig_cache = None
        return nid

    def add_edge(self, src: int, dst: int) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge ({src},{dst}) references unknown node")
        self._children[src].append(dst)
        self._parents[dst].append(src)
        self._sig_cache = None

    # -- accessors -----------------------------------------------------------
    def children(self, nid: int) -> List[int]:
        return self._children[nid]

    def parents(self, nid: int) -> List[int]:
        return self._parents[nid]

    @property
    def edges(self) -> List[Tuple[int, int]]:
        return [(s, d) for s, cs in self._children.items() for d in cs]

    @property
    def scans(self) -> List[int]:
        return [n.id for n in self.nodes.values() if n.is_scan]

    @property
    def writes(self) -> List[int]:
        return [n.id for n in self.nodes.values() if n.is_write]

    @property
    def partition_nodes(self) -> List[int]:
        return [n.id for n in self.nodes.values() if n.is_partition]

    def find_scanner(self, dataset: str) -> Optional[int]:
        for nid in self.scans:
            if self.nodes[nid].params.get("dataset") == dataset:
                return nid
        return None

    # -- structure -----------------------------------------------------------
    def toposort(self, within: Optional[Set[int]] = None) -> List[int]:
        ids = set(self.nodes) if within is None else set(within)
        indeg = {i: sum(1 for p in self._parents[i] if p in ids) for i in ids}
        frontier = sorted(i for i in ids if indeg[i] == 0)
        out: List[int] = []
        while frontier:
            n = frontier.pop(0)
            out.append(n)
            for c in self._children[n]:
                if c in ids:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        frontier.append(c)
            frontier.sort()
        if len(out) != len(ids):
            raise ValueError("IR graph contains a cycle")
        return out

    def all_paths(self, src: int, dst: int, limit: int = 10_000) -> List[List[int]]:
        """All simple src→dst paths (DFS).  Analytics IR DAGs are small."""
        paths: List[List[int]] = []
        stack: List[Tuple[int, List[int]]] = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                paths.append(path)
                if len(paths) >= limit:
                    break
                continue
            for c in self._children[node]:
                if c not in path:
                    stack.append((c, path + [c]))
        return paths

    def subgraph(self, node_ids: Sequence[int]) -> "IRGraph":
        keep = set(node_ids)
        g = IRGraph()
        remap: Dict[int, int] = {}
        for nid in self.toposort(within=keep):
            n = self.nodes[nid]
            remap[nid] = g.add_node(n.label, n.params)
        for s, d in self.edges:
            if s in keep and d in keep:
                g.add_edge(remap[s], remap[d])
        return g

    # -- signatures (paper §3.1.1 / §3.2) -------------------------------------
    def path_signature(self, path: Sequence[int]) -> str:
        return "/".join(self.nodes[n].signature_token() for n in path)

    def path_signatures(self, src: int, dst: int) -> List[str]:
        return sorted(self.path_signature(p) for p in self.all_paths(src, dst))

    def graph_signature(self) -> str:
        """Hash signature per §3.1.1: enumerate, sort and concatenate all
        distinct scan→leaf path signatures.

        The paper hashes scan→write paths; we additionally include paths to
        non-write leaves (e.g. a partition branch that feeds no write) so
        two workloads differing only in such a branch never collide — a
        strict refinement (identical to the paper whenever writes are the
        only leaves).

        Memoized until the graph structure changes (``add_node`` /
        ``add_edge`` invalidate): the signature keys the Session's
        PhysicalPlan cache, so repeated runs of a frozen workload must not
        pay the path enumeration again."""
        if self._sig_cache is not None:
            return self._sig_cache
        sigs: List[str] = []
        leaves = self.leaves()
        for s in self.scans:
            for o in leaves:
                if o == s:
                    continue
                sigs.extend(self.path_signature(p) for p in self.all_paths(s, o))
        digest = hashlib.sha256("|".join(sorted(set(sigs))).encode()).hexdigest()
        self._sig_cache = digest
        return digest

    # -- two-terminal property -------------------------------------------------
    def roots(self) -> List[int]:
        return [i for i in self.nodes if not self._parents[i]]

    def leaves(self) -> List[int]:
        return [i for i in self.nodes if not self._children[i]]

    def is_two_terminal(self) -> bool:
        return len(self.roots()) == 1 and len(self.leaves()) == 1

    # -- executability: the PlinyCompute property ------------------------------
    def compile_fn(self) -> Callable:
        """Compose node fns of a two-terminal subgraph into one callable
        ``f(dataset_value) -> key``.  Requires every node fn to resolve."""
        if not self.is_two_terminal():
            raise ValueError("compile_fn requires a two-terminal subgraph")
        (root,), (leaf,) = self.roots(), self.leaves()
        order = self.toposort()
        fns = {}
        for nid in order:
            fn = self.nodes[nid].fn()
            if fn is None:
                raise ValueError(
                    f"node {nid} ({self.nodes[nid].label}) is not executable")
            fns[nid] = fn

        parents = {i: list(self._parents[i]) for i in order}

        def run(value):
            vals: Dict[int, Any] = {}
            for nid in order:
                if nid == root:
                    vals[nid] = fns[nid](value)
                else:
                    args = [vals[p] for p in parents[nid]]
                    vals[nid] = fns[nid](*args)
            return vals[leaf]

        return run

    # -- misc -------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def pretty(self) -> str:
        lines = []
        for nid in self.toposort():
            n = self.nodes[nid]
            kids = ",".join(map(str, self._children[nid])) or "-"
            lines.append(f"  [{nid}] {n.label} -> {kids}")
        return "\n".join(lines)


def to_numpy(v) -> np.ndarray:
    """A node value (numpy array, torch tensor on any device, scalar) as a
    host numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
