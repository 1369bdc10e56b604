"""Tracing DSL embedded in Python — the paper's lambda-calculus embedding.

Users write UDF-centric workloads against :class:`Col` handles; tracing
builds the :class:`~repro_torch.core.ir.IRGraph`.  Example (paper Listing 1/2):

    wl = Workload("author-integrator")
    reviews = wl.scan("reviews")
    authors = wl.scan("authors")
    j = wl.join(reviews, authors,
                left_key=reviews.parse("json")["author"],
                right_key=authors.parse("csv")["author"])
    wl.write(j, "integrated")

The join lowers to ``partition(left_key) + partition(right_key) + join`` —
exactly the shape from which Alg. 1/2 extract partitioner candidates.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .ir import IRGraph


class Col:
    """A handle to an IR node producing a per-object value."""

    def __init__(self, wl: "Workload", nid: int):
        self._wl = wl
        self._nid = nid

    # lambda abstraction: member access
    def __getitem__(self, name: str) -> "Col":
        return self._wl._unary(f"attr:{name}", self)

    def attr(self, name: str) -> "Col":
        return self[name]

    def parse(self, fmt: str) -> "Col":
        return self._wl._unary(f"parse:{fmt}", self)

    def func(self, name: str) -> "Col":
        return self._wl._unary(f"func:{name}", self)

    def apply(self, fn: Callable, tag: str) -> "Col":
        return self._wl._unary(f"opaque:{tag}", self, params={"fn": fn})

    def _bin(self, op: str, other: Any) -> "Col":
        other = self._wl.lit(other) if not isinstance(other, Col) else other
        return self._wl._binary(f"binop:{op}", self, other)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("==", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("!=", o)

    def __lt__(self, o):
        return self._bin("<", o)

    def __gt__(self, o):
        return self._bin(">", o)

    def __le__(self, o):
        return self._bin("<=", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    def __add__(self, o):
        return self._bin("+", o)

    def __sub__(self, o):
        return self._bin("-", o)

    def __mul__(self, o):
        return self._bin("*", o)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __mod__(self, o):
        return self._bin("%", o)

    def __hash__(self):
        return id(self)


class SetHandle(Col):
    """Handle to a set-valued node (scan / join / aggregate output...)."""


class Workload:
    """A traced workload; owns one IRGraph."""

    def __init__(self, app_id: str):
        self.app_id = app_id
        self.graph = IRGraph()

    # -- node helpers ---------------------------------------------------------
    def _unary(self, label: str, x: Col, params: Optional[Dict] = None) -> Col:
        nid = self.graph.add_node(label, params)
        self.graph.add_edge(x._nid, nid)
        return Col(self, nid)

    def _binary(self, label: str, a: Col, b: Col) -> Col:
        nid = self.graph.add_node(label)
        self.graph.add_edge(a._nid, nid)
        self.graph.add_edge(b._nid, nid)
        return Col(self, nid)

    def lit(self, value: Any) -> Col:
        nid = self.graph.add_node(f"literal:{value!r}", {"value": value})
        return Col(self, nid)

    # -- set-based operators ----------------------------------------------------
    def scan(self, dataset: str) -> SetHandle:
        nid = self.graph.add_node("scan", {"dataset": dataset})
        return SetHandle(self, nid)

    def partition(self, key: Col, strategy: str = "hash") -> SetHandle:
        nid = self.graph.add_node("partition", {"strategy": strategy})
        self.graph.add_edge(key._nid, nid)
        return SetHandle(self, nid)

    def join(self, left: SetHandle, right: SetHandle, *, left_key: Col,
             right_key: Col, strategy: str = "hash",
             projection: Optional[Callable] = None,
             tag: str = "join") -> SetHandle:
        """Hash join: lowered to partition(left_key) ⋈ partition(right_key),
        the IR shape of Fig. 2 in the paper (after join-strategy selection)."""
        lp = self.partition(left_key, strategy)
        rp = self.partition(right_key, strategy)
        nid = self.graph.add_node("join", {"projection": projection,
                                           "tag": tag})
        self.graph.add_edge(lp._nid, nid)
        self.graph.add_edge(rp._nid, nid)
        return SetHandle(self, nid)

    def aggregate(self, x: SetHandle, *, key: Optional[Col] = None,
                  reducer: str = "sum",
                  fn: Optional[Callable] = None) -> SetHandle:
        """Keyed aggregation; a keyed aggregate also repartitions by key, so
        it contributes a partition node (shuffle) like a join side does."""
        if key is not None:
            x = self.partition(key, "hash")
        nid = self.graph.add_node("aggregate", {"reducer": reducer, "fn": fn})
        self.graph.add_edge(x._nid, nid)
        return SetHandle(self, nid)

    def filter(self, x: SetHandle, pred: Col) -> SetHandle:
        nid = self.graph.add_node("filter")
        self.graph.add_edge(x._nid, nid)
        self.graph.add_edge(pred._nid, nid)
        return SetHandle(self, nid)

    def map(self, x: SetHandle, fn: Callable, tag: str) -> SetHandle:
        nid = self.graph.add_node("apply", {"fn": fn, "tag": tag})
        self.graph.add_edge(x._nid, nid)
        return SetHandle(self, nid)

    def flatten(self, x: SetHandle) -> SetHandle:
        nid = self.graph.add_node("flatten")
        self.graph.add_edge(x._nid, nid)
        return SetHandle(self, nid)

    def write(self, x: SetHandle, dataset: str) -> SetHandle:
        nid = self.graph.add_node("write", {"dataset": dataset})
        self.graph.add_edge(x._nid, nid)
        return SetHandle(self, nid)

    # -- convenience --------------------------------------------------------------
    def signature(self) -> str:
        return self.graph.graph_signature()


# ---------------------------------------------------------------------------
# Canned workloads used throughout tests/benchmarks (paper §5.1)
# ---------------------------------------------------------------------------

def reddit_loader(name: str, dataset: str, out: str, fmt: str) -> Workload:
    """Producer: load (parse) a raw file set and write to storage."""
    wl = Workload(name)
    raw = wl.scan(dataset)
    parsed = wl.map(raw, fn=lambda x: x, tag=f"parse_{fmt}")
    wl.write(parsed, out)
    return wl


def author_integrator() -> Workload:
    """Paper Listing 1: join reviews (json) with authors (csv) on author."""
    wl = Workload("author-integrator")
    subs = wl.scan("submissions")
    auth = wl.scan("authors")
    j = wl.join(subs, auth,
                left_key=subs.parse("json")["author"],
                right_key=auth.parse("csv")["author"],
                tag="author_join")
    wl.write(j, "integrated")
    return wl


def pagerank_iteration() -> Workload:
    """Paper §5.2.2: join Pages with Ranks on url, aggregate new ranks."""
    wl = Workload("pagerank-iter")
    pages = wl.scan("pages")
    ranks = wl.scan("ranks")
    j = wl.join(pages, ranks,
                left_key=pages["url"], right_key=ranks["url"],
                tag="pr_join")
    contrib = wl.flatten(wl.map(j, fn=None, tag="emit_contribs"))
    agg = wl.aggregate(contrib, key=contrib["url"], reducer="sum")
    new_ranks = wl.map(agg, fn=None, tag="finish_ranks")  # damping + rename
    wl.write(new_ranks, "ranks")
    return wl


def matmul_workload(transpose_left: bool = False) -> Workload:
    """Paper §5.2.3: blocked matmul — join left blocks (col id) with right
    blocks (row id), multiply, aggregate partial products by (row, col)."""
    wl = Workload("block-matmul" + ("-gram" if transpose_left else ""))
    lhs = wl.scan("lhs_blocks")
    rhs = wl.scan("rhs_blocks")
    lkey = lhs["row_id"] if transpose_left else lhs["col_id"]
    j = wl.join(lhs, rhs, left_key=lkey, right_key=rhs["row_id"],
                tag="block_join")
    prods = wl.map(j, fn=None, tag="mkl_gemm")
    out = wl.aggregate(prods, key=prods["out_block_id"], reducer="sum")
    wl.write(out, "product_blocks")
    return wl
