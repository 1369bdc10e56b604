"""Span tracer — the timeline half of the observability layer (DESIGN §13).

One process-global :class:`Tracer` records **spans**: named, timed
intervals with parent↔child links, organized per thread via a
thread-local context stack and stamped off one monotonic clock
(``time.perf_counter``).  Finished spans land in a bounded ring buffer
(old spans fall off; a long-lived service never grows without bound) and
export as Chrome ``trace_event`` JSON loadable in Perfetto /
``chrome://tracing`` (the exporter module is not ported yet).

Overhead contract: tracing is **off by default** and the disabled path is
one module-global load plus one shared no-op object — no allocation, no
clock read, no lock (``bench_overhead.tracing_overhead`` prices it
against the plan-cache-hit path and asserts <2%).  Three modes:

``off``      every ``span()`` call returns the shared no-op span.
``sampled``  1-in-``sample_every`` *root* spans record; children follow
             their root's verdict, so sampled traces stay complete trees.
``full``     everything records.

Cross-thread parenting: a span does not survive a thread handoff by
itself (the context stack is thread-local), so the submitting side
captures ``tracer.context()`` and the worker runs inside
``with tracer.attach(ctx):`` — child spans then parent to the capturing
span across the pool boundary, and the exporter draws the handoff as a
Chrome flow arrow.  The serving tier (submit → ticket worker) and the
Autopilot (facade → optimizer thread ticks) both use this.

Cross-*process* parenting (DESIGN §15) works the same way, one
serialization step removed: :meth:`TraceContext.to_wire` /
:meth:`TraceContext.from_wire` move a context through any dict carrier
(a JSON file under the store, or the ``LACHESIS_TRACE_CONTEXT`` env var
for spawned subprocesses), and the receiving process runs under
``tracer.attach(ctx)`` exactly as a worker thread would.  Because
``perf_counter`` has a per-process epoch, each context also carries a
wall-clock capture stamp (``captured_unix``) and each process's span
spill records a (perf, unix) anchor pair — the merge step in
the exporter rebases every process onto the shared wall
clock and draws the handoff as a cross-process flow arrow.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

__all__ = ["Span", "TraceContext", "Tracer", "TRACER", "TRACE_ENV_VAR",
           "span", "configure", "enable", "disable", "tracing_mode",
           "finished_spans", "open_spans", "clear_spans"]

#: env-var carrier for a wire-format TraceContext (spawned subprocesses)
TRACE_ENV_VAR = "LACHESIS_TRACE_CONTEXT"

#: wire-format schema version for serialized TraceContexts
CONTEXT_WIRE_VERSION = 1

_ids = itertools.count(1)            # span ids (atomic under the GIL)
_trace_ids = itertools.count(1)      # trace ids (one per root span)


@dataclass
class Span:
    """One finished (or in-flight) timed interval."""
    name: str
    cat: str
    span_id: int
    parent_id: Optional[int]
    trace_id: int
    tid: int                          # OS thread ident
    thread_name: str
    t0: float                         # perf_counter at enter
    t1: Optional[float] = None        # perf_counter at exit (None = open)
    args: Dict[str, Any] = field(default_factory=dict)
    # set when the parent link crosses a thread handoff (tracer.attach):
    # (parent span id, parent tid, capture time) — the exporter emits a
    # Chrome flow arrow from there to this span's start
    flow_from: Optional["TraceContext"] = None

    @property
    def dur_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **kw) -> "Span":
        """Attach key=value annotations (shown in the trace viewer)."""
        self.args.update(kw)
        return self

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        TRACER._finish(self)
        return False


class _NullSpan:
    """The shared disabled span: every operation is a no-op returning
    ``self`` so instrumentation sites never branch on the mode."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **kw) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _SuppressSpan:
    """Root-not-sampled marker: suppresses child recording for its extent
    (so a sampled tracer emits whole trees or nothing)."""
    __slots__ = ("_local",)

    def __init__(self, local):
        self._local = local

    def __enter__(self) -> "_SuppressSpan":
        self._local.suppress += 1
        return self

    def __exit__(self, *exc) -> bool:
        self._local.suppress -= 1
        return False

    def set(self, **kw) -> "_SuppressSpan":
        return self


@dataclass(frozen=True)
class TraceContext:
    """Capturable link target for cross-thread (and, serialized, for
    cross-process) parenting.  Immutable.

    ``captured_at`` is the capturing process's ``perf_counter`` — only
    meaningful inside that process.  ``captured_unix`` is the wall-clock
    stamp taken at the same instant, the coordinate the cross-process
    merge uses; ``process`` names the capturing process so the merged
    trace can route the flow arrow back to its timeline.
    """
    trace_id: int
    span_id: int
    tid: int
    thread_name: str
    captured_at: float
    process: str = ""
    captured_unix: float = 0.0

    # -- wire format (cross-process carrier) ---------------------------------
    def to_wire(self) -> Dict[str, Any]:
        """Serializable dict form (versioned; survives JSON round-trip)."""
        return {"v": CONTEXT_WIRE_VERSION, "trace_id": self.trace_id,
                "span_id": self.span_id, "tid": self.tid,
                "thread_name": self.thread_name, "process": self.process,
                "captured_unix": self.captured_unix}

    @classmethod
    def from_wire(cls, wire: Mapping[str, Any]) -> "TraceContext":
        """Rebuild a context from its wire dict.  Tolerant of *older*
        wire versions (missing fields default); a *newer* version raises
        so a mixed-version cluster fails loudly instead of mis-linking."""
        v = int(wire.get("v", 1))
        if v > CONTEXT_WIRE_VERSION:
            raise ValueError(
                f"trace context wire version {v} is newer than supported "
                f"{CONTEXT_WIRE_VERSION}")
        return cls(trace_id=int(wire["trace_id"]),
                   span_id=int(wire["span_id"]),
                   tid=int(wire.get("tid", 0)),
                   thread_name=str(wire.get("thread_name", "")),
                   captured_at=0.0,
                   process=str(wire.get("process", "")),
                   captured_unix=float(wire.get("captured_unix", 0.0)))

    def to_env(self) -> Dict[str, str]:
        """Env-var carrier: merge into a child process's environment."""
        return {TRACE_ENV_VAR: json.dumps(self.to_wire())}

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> Optional["TraceContext"]:
        """Read the env-var carrier (None when absent or unparseable)."""
        raw = (environ if environ is not None else os.environ).get(
            TRACE_ENV_VAR)
        if not raw:
            return None
        try:
            return cls.from_wire(json.loads(raw))
        except (ValueError, KeyError, TypeError):
            return None


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Span] = []            # open spans, innermost last
        self.suppress = 0                      # >0 → root was not sampled
        self.attached: Optional[TraceContext] = None


class Tracer:
    """Process-global span recorder (see module docstring)."""

    def __init__(self, buffer: int = 65536):
        self.mode = "off"
        self.sample_every = 16
        self.process = f"pid-{os.getpid()}"    # label for cross-process merge
        self._buffer = int(buffer)
        self._spans: List[Span] = []
        self._open: Dict[int, Span] = {}       # span_id → in-flight span
        self._lock = threading.Lock()          # guards ring buffer + _open
        self._local = _Local()
        self._sample_clock = itertools.count()
        self.dropped = 0                       # spans evicted from the ring

    # -- configuration -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def configure(self, mode: Optional[str] = None,
                  buffer: Optional[int] = None,
                  sample_every: Optional[int] = None,
                  process: Optional[str] = None) -> "Tracer":
        global _OFF
        if mode is not None:
            if mode not in ("off", "sampled", "full"):
                raise ValueError(f"unknown tracing mode {mode!r} "
                                 "(use 'off', 'sampled' or 'full')")
            self.mode = mode
        if buffer is not None:
            if buffer < 1:
                raise ValueError("trace buffer must be >= 1")
            self._buffer = int(buffer)
            with self._lock:
                self._evict()
        if sample_every is not None:
            if sample_every < 1:
                raise ValueError("sample_every must be >= 1")
            self.sample_every = int(sample_every)
        if process is not None:
            if not process:
                raise ValueError("process label must be non-empty")
            self.process = str(process)
        _OFF = self.mode == "off"
        return self

    # -- span lifecycle ------------------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Start a span (use as a context manager).  Near-free when off."""
        if _OFF:
            return NULL_SPAN
        return self._start(name, cat, args)

    def _start(self, name: str, cat: str, args: Dict[str, Any]):
        local = self._local
        if local.suppress:
            return _SuppressSpan(local)
        parent = local.stack[-1] if local.stack else None
        flow = None
        if parent is None and local.attached is not None:
            ctx = local.attached
            trace_id, parent_id = ctx.trace_id, ctx.span_id
            flow = ctx
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            # a fresh root: sampling decides whether this tree records
            if self.mode == "sampled" and \
                    next(self._sample_clock) % self.sample_every:
                return _SuppressSpan(local)
            trace_id, parent_id = next(_trace_ids), None
        t = threading.current_thread()
        sp = Span(name=name, cat=cat, span_id=next(_ids),
                  parent_id=parent_id, trace_id=trace_id,
                  tid=t.ident or 0, thread_name=t.name,
                  t0=time.perf_counter(), args=dict(args), flow_from=flow)
        local.stack.append(sp)
        with self._lock:
            self._open[sp.span_id] = sp
        return sp

    def _finish(self, sp: Span) -> None:
        sp.t1 = time.perf_counter()
        stack = self._local.stack
        # normal case: sp is the innermost open span on this thread
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:                      # mismatched exits — recover
            stack.remove(sp)
        with self._lock:
            self._open.pop(sp.span_id, None)
            self._spans.append(sp)
            self._evict()

    def _evict(self) -> None:
        # caller holds _lock
        if len(self._spans) > self._buffer:
            n = len(self._spans) - self._buffer
            del self._spans[:n]
            self.dropped += n

    # -- cross-thread parenting ----------------------------------------------
    def context(self) -> Optional[TraceContext]:
        """Capture the current span as a link target for another thread
        (None when nothing is recording here)."""
        if _OFF:
            return None
        local = self._local
        if local.suppress:
            return None
        if local.stack:
            sp = local.stack[-1]
            t = threading.current_thread()
            return TraceContext(trace_id=sp.trace_id, span_id=sp.span_id,
                                tid=t.ident or 0, thread_name=t.name,
                                captured_at=time.perf_counter(),
                                process=self.process,
                                captured_unix=time.time())
        return local.attached

    def attach(self, ctx: Optional[TraceContext]):
        """Run a block with ``ctx`` as the adopted parent: root spans
        opened inside parent to the capturing span (even though it lives
        on another thread) and export with a flow arrow."""
        return _Attach(self._local, ctx)

    # -- inspection ----------------------------------------------------------
    def finished(self) -> List[Span]:
        """Snapshot of the ring buffer (closed spans, oldest first)."""
        with self._lock:
            return list(self._spans)

    def open(self) -> List[Span]:
        """Snapshot of currently in-flight spans (any thread).  A crash
        dump of these is what lets an aborted process's last span survive
        into the merged trace (DESIGN §15)."""
        with self._lock:
            return list(self._open.values())

    def anchor(self) -> Dict[str, Any]:
        """A (perf_counter, wall-clock) pair stamped at the same instant —
        the coordinate transform the cross-process merge needs to rebase
        this process's spans onto the shared wall clock."""
        return {"process": self.process, "pid": os.getpid(),
                "anchor_perf": time.perf_counter(),
                "anchor_unix": time.time()}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open.clear()
            self.dropped = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._spans)
            n_open = len(self._open)
        return {"mode": self.mode, "buffered": n, "open": n_open,
                "dropped": self.dropped, "buffer": self._buffer,
                "sample_every": self.sample_every, "process": self.process}


class _Attach:
    __slots__ = ("_local", "_ctx", "_prev")

    def __init__(self, local: _Local, ctx: Optional[TraceContext]):
        self._local = local
        self._ctx = ctx

    def __enter__(self):
        self._prev = self._local.attached
        self._local.attached = self._ctx
        return self

    def __exit__(self, *exc) -> bool:
        self._local.attached = self._prev
        return False


#: the process-global tracer every instrumentation site records into
TRACER = Tracer()
_OFF = True         # mirrors TRACER.mode — the one-load disabled check


def span(name: str, cat: str = "", **args):
    """Module-level shortcut: ``with span("exec.scan", dataset=...)``."""
    if _OFF:
        return NULL_SPAN
    return TRACER._start(name, cat, args)


def configure(**kw) -> Tracer:
    return TRACER.configure(**kw)


def enable(mode: str = "full", **kw) -> Tracer:
    return TRACER.configure(mode=mode, **kw)


def disable() -> Tracer:
    return TRACER.configure(mode="off")


def tracing_mode() -> str:
    return TRACER.mode


def finished_spans() -> List[Span]:
    return TRACER.finished()


def open_spans() -> List[Span]:
    return TRACER.open()


def clear_spans() -> None:
    TRACER.clear()
