"""The device trace of a traced run, and what the per-layer readers take
from it.

:func:`traced` runs a callable under ``torch.profiler`` (CPU and CUDA
activity, input shapes recorded) inside a span named
:data:`WINDOW_SPAN`, and reduces the events to a :class:`Trace`: the
window's length, the seconds in which some device operation ran (the
union of their intervals), the device operations that took most time,
the idle gaps summed by what the host was doing, and every call of the
port's kernel custom ops with its input shapes and the device time of
the kernels it launched (its children's included).  A reader that finds
nothing to read returns None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .yardstick import peaks

WINDOW_SPAN = "perfbench.window"
#: the port's kernel custom ops, read by name
KERNEL_OPS = ("repro_torch::flash_attention", "repro_torch::flash_attention_lse",
              "repro_torch::flash_attention_backward", "repro_torch::ssd_scan",
              "repro_torch::ssd_scan_backward")
#: characters of an operation's name kept in the breakdown
NAME_CHARS = 160
#: gaps labelled by the host op beneath them (the longest first)
LABELLED_GAPS = 400


@dataclass
class OpCall:
    name: str
    shapes: List[List[int]]
    concrete: List
    dtypes: List[str]
    device_s: float


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    calls: Dict[str, List[OpCall]] = field(default_factory=dict)

    def breakdown(self) -> Dict:
        """The ten device operations that took most time and the ten host
        labels under the most idle time, names cut to
        :data:`NAME_CHARS` characters (a kernel's full template name can
        run to thousands)."""
        return {"device_ops": [[n[:NAME_CHARS], s]
                               for n, s in self.device_ops[:10]],
                "idle_gaps": [[n[:NAME_CHARS], s]
                              for n, s in self.idle_gaps[:10]]}


def traced(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler and reduce its events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=True) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return reduce_events(prof.events())


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set on the card (the window's
    own span, mirrored on the device's timeline, is none)."""
    return (not _is_host(e) and e.name != WINDOW_SPAN
            and not getattr(e, "is_user_annotation", False))


def _is_host(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)) == "CPU"


def merge(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events) -> Trace:
    span = [e for e in events if e.name == WINDOW_SPAN and _is_host(e)]
    if not span:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    dev = [e for e in events if _is_device(e)]
    spans = merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev if e.time_range.end > w0
                   and e.time_range.start < w1])
    busy_us = sum(b - a for a, b in spans)
    per_op: Dict[str, float] = defaultdict(float)
    for e in dev:
        per_op[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])
    gaps = []
    edges = [w0] + [x for ab in spans for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted((e for e in events
                   if _is_host(e) and e.name != WINDOW_SPAN),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps[:LABELLED_GAPS]:
        idle[_host_label(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:]) * 1e-6
    if rest > 0:
        idle["(shorter gaps)"] += rest
    calls: Dict[str, List[OpCall]] = defaultdict(list)
    for e in host:
        if e.name in KERNEL_OPS:
            calls[e.name].append(OpCall(
                e.name, [list(s) for s in (e.input_shapes or [])],
                list(getattr(e, "concrete_inputs", None) or []),
                [str(d) for d in (getattr(e, "input_dtypes", None) or [])],
                float(e.device_time_total) * 1e-6))
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                 device_ops=device_ops,
                 idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1]),
                 calls=dict(calls))


def _host_label(host, starts, t: float) -> str:
    """The innermost host event running at time ``t`` (the one that began
    last among those still running), or "(python)" where none is."""
    i = bisect.bisect_right(starts, t) - 1
    scanned = 0
    while i >= 0 and scanned < 20000:
        e = host[i]
        if e.time_range.end >= t:
            return e.name
        i -= 1
        scanned += 1
    return "(python)"


# ---------------------------------------------------------------------------
# What the readers take from a trace
# ---------------------------------------------------------------------------

def idle_share(trace: Optional[Trace]) -> Optional[float]:
    """Per cent of the traced window in which no device operation ran."""
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def _itemsize(call: OpCall, default: int) -> int:
    if call.dtypes:
        d = call.dtypes[0].lower()
        if "bfloat16" in d or "half" in d or "float16" in d:
            return 2
        if "float" in d:
            return 4
    return default


def _flag(call: OpCall, index: int, default):
    """A scalar argument the profiler recorded, else ``default``."""
    if index < len(call.concrete):
        v = call.concrete[index]
        if v not in ("", None, []):
            if isinstance(v, str):
                low = v.lower()
                if low in ("true", "false"):
                    return low == "true"
                try:
                    return int(v)
                except ValueError:
                    return default
            return v
    return default


def call_work(call: OpCall, itemsize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one kernel op call from its input shapes, by the
    frozen formulas of :mod:`.yardstick.cost`."""
    from .yardstick import cost
    size = _itemsize(call, itemsize)
    s = call.shapes
    if call.name in ("repro_torch::flash_attention",
                     "repro_torch::flash_attention_lse"):
        (B, H, Sq, hd), (_, KV, Skv, _) = s[0], s[1]
        causal, window = _flag(call, 3, True), _flag(call, 4, None)
        return cost.flash_attention_cost(
            B, H, KV, Sq, Skv, hd, bool(causal), window, size,
            lse=call.name.endswith("_lse"))
    if call.name == "repro_torch::flash_attention_backward":
        (B, H, Sq, hd), (_, KV, Skv, _) = s[0], s[1]
        causal, window = _flag(call, 6, True), _flag(call, 7, None)
        return cost.flash_attention_bwd_cost(B, H, KV, Sq, Skv, hd,
                                             bool(causal), window, size)
    if call.name in ("repro_torch::ssd_scan",
                     "repro_torch::ssd_scan_backward"):
        (B, T, H, P), N = s[0], s[3][-1]
        chunk = int(_flag(call, 5 if call.name.endswith("scan") else 7, 256))
        fn = (cost.ssd_scan_cost if call.name.endswith("scan")
              else cost.ssd_scan_bwd_cost)
        return fn(B, T, H, P, N, chunk, size)
    raise KeyError(call.name)


def roofline(trace: Optional[Trace], ops: Sequence[str],
             itemsize: int = 2) -> Optional[float]:
    """Per cent: the least time of every traced call of ``ops`` (each
    call's larger of FLOPs over the bf16 peak and bytes over HBM's) over
    the device time their kernels took.  None where no call with device
    time was traced."""
    if trace is None:
        return None
    least = measured = 0.0
    for name in ops:
        for call in trace.calls.get(name, []):
            if call.device_s <= 0:
                continue
            least += peaks.least_seconds(*call_work(call, itemsize))
            measured += call.device_s
    if measured <= 0:
        return None
    return 100.0 * least / measured
