"""Where a traced run's device time goes, by the port's LM spans.

With the port's tracer on (``repro_torch.obs.enable("full")``), each LM
span it records is also a ``record_function`` on the profiler's host
timeline: the step phases (``lm.train_step`` ⊃ ``lm.forward``,
``lm.backward``, ``lm.optimizer``; ``lm.serve_batch`` ⊃ ``lm.prefill``,
``lm.decode`` ⊃ ``lm.decode_step``) and the model components
(``lm.embed``, ``lm.mixer``, ``lm.ffn``, ``lm.head``, ``lm.loss``).
:func:`attribute` puts each device operation of a trace (a kernel, copy
or set on the card) down to one phase and at most one component:

1. it was launched by the CUDA runtime or driver call that shares its id
   (CUPTI's correlation id; the profiler puts that call on the thread of
   the op that made it), at that call's start;
2. its component is the innermost component span open on the launching
   thread at the launch;
3. an op launched in the backward, under an
   ``autograd::engine::evaluate_function: …`` event and outside any
   component span, takes the component of the forward op with the same
   ``sequence_nr`` on the forward thread (``fwd_thread``): PyTorch's own
   link from a backward node to the op that recorded it;
4. its phase is the innermost phase span open on any thread at the
   launch (on autograd's thread, where none is open, the caller's
   ``lm.backward``).

A device op that no launch claims is put down to :data:`UNLINKED`; one
launched outside every phase, or outside every component, to
:data:`NONE`.  The metric functions at the end return None where their
spans or device ops are absent, as in a trace of a program without the
spans, or on the CPU.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import WINDOW_SPAN, _is_device, _is_host, merge

PHASES = ("lm.train_step", "lm.forward", "lm.backward", "lm.optimizer",
          "lm.serve_batch", "lm.prefill", "lm.decode", "lm.decode_step")
COMPONENTS = ("lm.embed", "lm.mixer", "lm.ffn", "lm.head", "lm.loss")
#: the autograd engine's event around each backward node it runs
BACKWARD_NODE = "autograd::engine::evaluate_function: "
NONE = "(none)"
UNLINKED = "(unlinked)"


@dataclass
class Spans:
    """Device seconds of the trace by phase and by (phase, component),
    device ops by phase, span counts, and the ``lm.decode`` spans' union
    beside the device's busy time within it."""
    device_s: float = 0.0
    phase_s: Dict[str, float] = field(default_factory=dict)
    component_s: Dict[Tuple[str, str], float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    decode_s: float = 0.0
    decode_busy_s: float = 0.0

    def component_total(self, component: str) -> float:
        return sum(s for (_, c), s in self.component_s.items()
                   if c == component)


def _innermost(intervals: Dict[int, List[Tuple[float, float, object]]],
               queries: Sequence[Tuple[int, float]]) -> List[object]:
    """For each query (thread, time), the payload of the innermost
    interval of that thread that holds the time (the one that began last
    among those still open), or None.  Intervals of one thread nest, as
    ``with`` blocks do."""
    out: List[object] = [None] * len(queries)
    by_thread: Dict[int, List[int]] = defaultdict(list)
    for i, (tid, _) in enumerate(queries):
        by_thread[tid].append(i)
    for tid, idx in by_thread.items():
        ivs = sorted(intervals.get(tid, ()), key=lambda v: (v[0], -v[1]))
        if not ivs:
            continue
        idx.sort(key=lambda i: queries[i][1])
        stack: List[Tuple[float, float, object]] = []
        j = 0
        for i in idx:
            t = queries[i][1]
            while j < len(ivs) and ivs[j][0] <= t:
                while stack and stack[-1][1] < ivs[j][0]:
                    stack.pop()
                stack.append(ivs[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack:
                out[i] = stack[-1][2]
    return out


def _is_launch(e) -> bool:
    """A CUDA runtime (``cuda…``) or driver (``cuLaunchKernel``…) call."""
    n = e.name
    return n.startswith("cuda") or (n.startswith("cu") and n[2:3].isupper())


def _window(events) -> Optional[Tuple[float, float]]:
    for e in events:
        if e.name == WINDOW_SPAN and _is_host(e):
            return e.time_range.start, e.time_range.end
    return None


def attribute(events: Iterable) -> Optional[Spans]:
    """The attribution of a profiler's events (``prof.events()``, the
    window span :data:`.trace.WINDOW_SPAN` among them); None where the
    trace holds no phase span."""
    events = list(events)
    w = _window(events)
    if w is None:
        return None
    w0, w1 = w
    host = [e for e in events if _is_host(e) and e.name != WINDOW_SPAN]
    spans = [e for e in host if e.name in PHASES or e.name in COMPONENTS]
    if not any(e.name in PHASES for e in spans):
        return None
    dev = [e for e in events if _is_device(e)
           and e.time_range.end > w0 and e.time_range.start < w1]
    # op ids and CUPTI's correlation ids are counted apart: only a launch
    # call shares a device op's id
    launches_by_id = {e.id: e for e in host if _is_launch(e)}

    def nested(names) -> Dict[int, List[Tuple[float, float, object]]]:
        out: Dict[int, List] = defaultdict(list)
        for e in host:
            if e.name in names:
                out[e.thread].append((e.time_range.start, e.time_range.end,
                                      e.name))
        return out

    comps = nested(COMPONENTS)
    nodes: Dict[int, List] = defaultdict(list)
    forward: Dict[Tuple[int, int], object] = {}
    for e in host:
        seq = getattr(e, "sequence_nr", -1)
        if seq is None or seq < 0:
            continue
        if e.name.startswith(BACKWARD_NODE):
            nodes[e.thread].append((e.time_range.start, e.time_range.end,
                                    (e.fwd_thread, seq)))
        elif not getattr(e, "fwd_thread", 0):
            prev = forward.get((e.thread, seq))
            if prev is None or prev.time_range.start < e.time_range.start:
                forward[(e.thread, seq)] = e
    # every phase span on one timeline: phases open on any thread count
    phases = {0: [(e.time_range.start, e.time_range.end, e.name)
                  for e in spans if e.name in PHASES]}

    launch = [launches_by_id.get(e.id) for e in dev]
    at = [(h.thread, h.time_range.start) for h in launch if h is not None]
    comp_at = iter(_innermost(comps, at))
    node_at = iter(_innermost(nodes, at))
    phase_at = iter(_innermost(phases, [(0, t) for _, t in at]))
    fwd_q = [(f.thread, f.time_range.start) for f in forward.values()]
    fwd_comp = dict(zip(forward, _innermost(comps, fwd_q)))

    out = Spans()
    phase_s: Dict[str, float] = defaultdict(float)
    comp_s: Dict[Tuple[str, str], float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for e, h in zip(dev, launch):
        s = (e.time_range.end - e.time_range.start) * 1e-6
        out.device_s += s
        if h is None:
            phase, comp = UNLINKED, NONE
        else:
            phase = next(phase_at) or NONE
            comp = next(comp_at)
            node = next(node_at)
            if comp is None and node is not None:
                comp = fwd_comp.get(node)
            comp = comp or NONE
        phase_s[phase] += s
        comp_s[(phase, comp)] += s
        launches[phase] += 1
    out.phase_s, out.component_s = dict(phase_s), dict(comp_s)
    out.launches = dict(launches)
    counts: Dict[str, int] = defaultdict(int)
    for e in spans:
        if w0 <= e.time_range.start <= w1:
            counts[e.name] += 1
    out.counts = dict(counts)
    decode = merge([(e.time_range.start, e.time_range.end) for e in spans
                    if e.name == "lm.decode"])
    busy = merge([(e.time_range.start, e.time_range.end) for e in dev])
    out.decode_s = sum(b - a for a, b in decode) * 1e-6
    out.decode_busy_s = _overlap(decode, busy) * 1e-6
    return out


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    total = 0.0
    starts = [x for x, _ in b]
    for lo, hi in a:
        k = max(bisect.bisect_right(starts, lo) - 1, 0)
        while k < len(b) and b[k][0] < hi:
            total += max(0.0, min(hi, b[k][1]) - max(lo, b[k][0]))
            k += 1
    return total


# ---------------------------------------------------------------------------
# The per-layer numbers read from an attribution
# ---------------------------------------------------------------------------

def _per(sp: Optional[Spans], span: str) -> Optional[int]:
    n = sp.counts.get(span, 0) if sp is not None else 0
    return n if n > 0 and sp.device_s > 0 else None


def mixer_ms_per_step(sp: Optional[Spans]) -> Optional[float]:
    """Device ms with component ``lm.mixer`` (forward, recomputation and
    backward) a ``lm.train_step``."""
    n = _per(sp, "lm.train_step")
    return None if n is None else 1e3 * sp.component_total("lm.mixer") / n


def optimizer_ms_per_step(sp: Optional[Spans]) -> Optional[float]:
    """Device ms in phase ``lm.optimizer`` a ``lm.train_step``."""
    n = _per(sp, "lm.train_step")
    return None if n is None else \
        1e3 * sp.phase_s.get("lm.optimizer", 0.0) / n


def decode_attn_ms_per_token(sp: Optional[Spans]) -> Optional[float]:
    """Device ms with component ``lm.mixer`` in phase ``lm.decode_step``,
    a decode step."""
    n = _per(sp, "lm.decode_step")
    return None if n is None else \
        1e3 * sp.component_s.get(("lm.decode_step", "lm.mixer"), 0.0) / n


def decode_launches_per_token(sp: Optional[Spans]) -> Optional[float]:
    """Device ops (kernels, copies, sets) in phase ``lm.decode_step``, a
    decode step."""
    n = _per(sp, "lm.decode_step")
    return None if n is None else sp.launches.get("lm.decode_step", 0) / n


def decode_idle_share(sp: Optional[Spans]) -> Optional[float]:
    """Per cent of the ``lm.decode`` spans' union in which no device op
    ran."""
    if _per(sp, "lm.decode") is None or sp.decode_s <= 0:
        return None
    return 100.0 * (1.0 - sp.decode_busy_s / sp.decode_s)
