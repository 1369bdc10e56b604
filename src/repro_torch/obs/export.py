"""Exporters: spans → Chrome ``trace_event`` JSON (Perfetto-loadable).

The Chrome trace-event format (the `catapult` JSON spec) is the lingua
franca of timeline viewers: ``chrome://tracing``, Perfetto's web UI and
``speedscope`` all open it directly.  We emit:

* one ``M`` (metadata) event per thread naming it (``thread_name``), so
  the serving pool workers and the Autopilot's optimizer thread show up
  labeled instead of as bare ids;
* one ``X`` (complete) event per finished span — ``ts``/``dur`` in
  microseconds off the tracer's shared ``perf_counter`` clock, ``args``
  carrying the span annotations plus our span/parent ids;
* still-open spans as ``X`` events too, flagged ``"incomplete": true``
  with duration-so-far — a crashed process's last in-flight span (the
  rebalance it died inside) survives into the trace instead of
  vanishing;
* an ``s``/``f`` (flow start/finish) pair for every cross-thread handoff
  a span recorded via ``tracer.attach`` — Perfetto draws these as arrows
  from the submitting span to the worker span, which is how a serve's
  ticket execution and the Autopilot's ticks visually attach to their
  origin.

Timestamps are rebased so the earliest span starts at t=0: perf_counter
has an arbitrary epoch and viewers dislike 6-digit-second offsets.

Cross-process stitching (DESIGN §15): each process *spills* its spans to
``<dir>/trace-<label>.jsonl`` (:func:`spill_spans`) — a header line with
a (perf_counter, wall-clock) anchor pair followed by one JSON record per
span, open spans included.  :func:`merge_process_traces` rebases every
file onto the shared wall clock via its anchor, assigns each process its
own Chrome ``pid`` (with ``process_name`` metadata rows), and pairs
``s``/``f`` flow events across process boundaries wherever a span's
root was attached to a :class:`~repro_torch.obs.tracer.TraceContext` that came
over the wire from another process — so the three ``cluster_smoke``
processes render as ONE causal trace.
"""

from __future__ import annotations

import glob
import json
import os
import time
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from .tracer import Span, TRACER, Tracer

__all__ = ["to_chrome_trace", "write_chrome_trace", "chrome_trace_json",
           "spill_spans", "load_spill", "merge_process_traces",
           "write_merged_trace", "SPILL_VERSION"]

#: process id stamped on every event of a single-process export
_PID = 1

#: schema version of the per-process span spill files
SPILL_VERSION = 1


def to_chrome_trace(spans: Optional[Iterable[Span]] = None,
                    metadata: Optional[Dict[str, Any]] = None,
                    include_open: bool = True) -> Dict[str, Any]:
    """Convert spans (default: the global tracer's buffer plus any
    still-open spans) into a Chrome trace-event document (the
    ``traceEvents`` object form).  Open spans export as ``X`` events
    flagged ``"incomplete": true`` with duration-so-far."""
    if spans is None:
        spans = TRACER.finished()
        if include_open:
            spans = spans + TRACER.open()
        now = time.perf_counter()
    else:
        spans = list(spans)
        # deterministic "now" for explicit span lists: the latest known
        # timestamp, so open-span durations don't depend on export time
        now = max((sp.t1 if sp.t1 is not None else sp.t0 for sp in spans),
                  default=0.0)
    if not include_open:
        spans = [sp for sp in spans if sp.t1 is not None]
    events: List[Dict[str, Any]] = []

    t_base = min((sp.t0 for sp in spans), default=0.0)

    def us(t: float) -> float:
        return round((t - t_base) * 1e6, 3)

    threads: Dict[int, str] = {}
    for sp in spans:
        threads.setdefault(sp.tid, sp.thread_name)
        if sp.flow_from is not None:
            threads.setdefault(sp.flow_from.tid, sp.flow_from.thread_name)

    for tid, name in sorted(threads.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": _PID,
                       "tid": tid, "args": {"name": name}})

    flow_n = 0
    incomplete = 0
    for sp in sorted(spans, key=lambda s: s.t0):
        args = {str(k): _jsonable(v) for k, v in sp.args.items()}
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        args["trace_id"] = sp.trace_id
        if sp.t1 is None:
            incomplete += 1
            args["incomplete"] = True
            dur = max(now - sp.t0, 0.0)
        else:
            dur = sp.dur_s
        events.append({"ph": "X", "name": sp.name, "cat": sp.cat or "span",
                       "pid": _PID, "tid": sp.tid,
                       "ts": us(sp.t0), "dur": round(dur * 1e6, 3),
                       "args": args})
        if sp.flow_from is not None:
            # arrow: from the capture point on the submitting thread to
            # this span's start on the worker thread
            flow_n += 1
            ctx = sp.flow_from
            events.append({"ph": "s", "id": flow_n, "name": "handoff",
                           "cat": "flow", "pid": _PID, "tid": ctx.tid,
                           "ts": us(min(ctx.captured_at, sp.t0))})
            events.append({"ph": "f", "id": flow_n, "name": "handoff",
                           "cat": "flow", "pid": _PID, "tid": sp.tid,
                           "ts": us(sp.t0), "bp": "e"})

    doc: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "repro_torch.obs", "spans": len(spans),
                      "incomplete": incomplete, "dropped": TRACER.dropped},
    }
    if metadata:
        doc["otherData"].update({str(k): _jsonable(v)
                                 for k, v in metadata.items()})
    return doc


def chrome_trace_json(spans: Optional[Iterable[Span]] = None,
                      metadata: Optional[Dict[str, Any]] = None) -> str:
    return json.dumps(to_chrome_trace(spans, metadata))


def write_chrome_trace(path: str,
                       spans: Optional[Iterable[Span]] = None,
                       metadata: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Write a Perfetto-loadable trace file; returns the document."""
    doc = to_chrome_trace(spans, metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# ---------------------------------------------------------------------------
# per-process span spill + cross-process merge (DESIGN §15)
# ---------------------------------------------------------------------------

def _safe_label(label: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "_" for c in label)


def _span_record(sp: Span) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "kind": "span", "name": sp.name, "cat": sp.cat,
        "span_id": sp.span_id, "parent_id": sp.parent_id,
        "trace_id": sp.trace_id, "tid": sp.tid,
        "thread_name": sp.thread_name, "t0": sp.t0, "t1": sp.t1,
        "args": {str(k): _jsonable(v) for k, v in sp.args.items()},
    }
    if sp.flow_from is not None:
        flow = sp.flow_from.to_wire()
        # keep the local perf-clock capture stamp too: intra-process
        # flows in the merged doc rebase it like any other timestamp
        flow["captured_at"] = sp.flow_from.captured_at
        rec["flow"] = flow
    return rec


def spill_spans(dir_path: str, label: Optional[str] = None,
                tracer: Optional[Tracer] = None,
                include_open: bool = True) -> str:
    """Write this process's spans to ``<dir>/trace-<label>.jsonl``.

    Line 1 is a header carrying the (perf_counter, wall-clock) anchor
    pair the merge step needs to rebase this process onto the shared
    wall clock; every following line is one span record.  Open spans are
    included by default (flagged by ``"t1": null``) — calling this from
    a crash path preserves the span the process died inside.
    """
    tr = tracer if tracer is not None else TRACER
    label = label or tr.process
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"trace-{_safe_label(label)}.jsonl")
    header = dict(tr.anchor(), kind="header", version=SPILL_VERSION,
                  label=label, mode=tr.mode, dropped=tr.dropped)
    spans = tr.finished()
    if include_open:
        spans = spans + tr.open()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(header) + "\n")
        for sp in spans:
            f.write(json.dumps(_span_record(sp)) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_spill(path: str) -> Optional[Dict[str, Any]]:
    """Parse one spill file → ``{"header": ..., "spans": [...]}``.

    Tolerant loader (same contract as decisions.log): torn trailing
    lines are ignored, a file whose header claims a *newer* spill
    version is skipped with a warning (returns None).
    """
    header: Optional[Dict[str, Any]] = None
    spans: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue                      # torn tail — ignore
            if not isinstance(rec, dict):
                continue
            if rec.get("kind") == "header":
                if int(rec.get("version", 1)) > SPILL_VERSION:
                    warnings.warn(
                        f"span spill {path} has version {rec.get('version')} "
                        f"> supported {SPILL_VERSION}; skipping file",
                        stacklevel=2)
                    return None
                header = rec
            elif rec.get("kind") == "span":
                spans.append(rec)
    if header is None:
        return None
    return {"header": header, "spans": spans}


def merge_process_traces(src: Union[str, Sequence[str]],
                         metadata: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """Stitch per-process spill files into ONE Chrome trace document.

    ``src`` is either a directory (every ``trace-*.jsonl`` inside) or an
    explicit list of spill paths.  Each file's anchor pair maps its
    process-local ``perf_counter`` timeline onto the shared wall clock;
    each process gets its own Chrome ``pid`` plus a ``process_name``
    metadata row, and every span whose root was attached to a wire-borne
    :class:`TraceContext` from another process gets a cross-process
    ``s``/``f`` flow pair back to the originating span's timeline.
    """
    if isinstance(src, str):
        paths = sorted(glob.glob(os.path.join(src, "trace-*.jsonl")))
    else:
        paths = list(src)
    files: List[Dict[str, Any]] = []
    skipped = 0
    for p in paths:
        loaded = load_spill(p)
        if loaded is None:
            skipped += 1
            continue
        h = loaded["header"]
        proc = str(h.get("process") or h.get("label")
                   or os.path.splitext(os.path.basename(p))[0])
        files.append({"process": proc, "header": h,
                      "spans": loaded["spans"]})

    # one Chrome pid per process, stable order
    pid_of = {f["process"]: i + 1 for i, f in enumerate(
        sorted(files, key=lambda f: f["process"]))}

    # rebase: unix_t = anchor_unix + (t - anchor_perf), per process
    def rebase_fn(h):
        a_perf = float(h.get("anchor_perf", 0.0))
        a_unix = float(h.get("anchor_unix", 0.0))
        return lambda t: a_unix + (float(t) - a_perf)

    starts: List[float] = []
    for f in files:
        rb = rebase_fn(f["header"])
        f["rebase"] = rb
        starts.extend(rb(rec["t0"]) for rec in f["spans"])
    t_base = min(starts, default=0.0)

    def us(t_unix: float) -> float:
        return round((t_unix - t_base) * 1e6, 3)

    events: List[Dict[str, Any]] = []
    for f in files:
        pid = pid_of[f["process"]]
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f["process"]}})
        threads: Dict[int, str] = {}
        for rec in f["spans"]:
            threads.setdefault(int(rec["tid"]), str(rec["thread_name"]))
        for tid, name in sorted(threads.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})

    flow_n = 0
    n_spans = 0
    n_incomplete = 0
    n_cross = 0
    dropped = 0
    for f in files:
        pid = pid_of[f["process"]]
        proc = f["process"]
        rb = f["rebase"]
        dropped += int(f["header"].get("dropped", 0))
        # an open span's duration-so-far runs to the spill moment — the
        # anchor is stamped at spill time, so that IS anchor_unix
        spill_unix = float(f["header"].get("anchor_unix", 0.0))
        for rec in sorted(f["spans"], key=lambda r: r["t0"]):
            n_spans += 1
            flow = rec.get("flow")
            t0 = rb(rec["t0"])
            args = dict(rec.get("args") or {})
            args["span_id"] = rec["span_id"]
            if rec.get("parent_id") is not None:
                args["parent_id"] = rec["parent_id"]
            args["trace_id"] = rec["trace_id"]
            args["process"] = proc
            # process-qualified ids: span ids are per-process counters,
            # so only the (process, id) pair is unique in a merged doc
            args["span_uid"] = f"{proc}/{rec['span_id']}"
            if flow is not None:
                origin = str(flow.get("process") or proc)
                args["parent_uid"] = f"{origin}/{flow['span_id']}"
            elif rec.get("parent_id") is not None:
                args["parent_uid"] = f"{proc}/{rec['parent_id']}"
            if rec.get("t1") is None:
                n_incomplete += 1
                args["incomplete"] = True
                dur = max(spill_unix - t0, 0.0)
            else:
                dur = rb(rec["t1"]) - t0
            events.append({"ph": "X", "name": rec["name"],
                           "cat": rec.get("cat") or "span",
                           "pid": pid, "tid": int(rec["tid"]),
                           "ts": us(t0), "dur": round(dur * 1e6, 3),
                           "args": args})
            if flow is not None:
                origin = str(flow.get("process") or proc)
                origin_pid = pid_of.get(origin, pid)
                cross = origin != proc
                if cross:
                    n_cross += 1
                    # cross-process: only the wall-clock stamp is valid
                    ts_s = float(flow.get("captured_unix") or 0.0) or t0
                else:
                    cap = flow.get("captured_at")
                    ts_s = rb(cap) if cap else t0
                flow_n += 1
                events.append({"ph": "s", "id": flow_n,
                               "name": "xproc" if cross else "handoff",
                               "cat": "flow", "pid": origin_pid,
                               "tid": int(flow.get("tid", 0)),
                               "ts": us(min(ts_s, t0))})
                events.append({"ph": "f", "id": flow_n,
                               "name": "xproc" if cross else "handoff",
                               "cat": "flow", "pid": pid,
                               "tid": int(rec["tid"]),
                               "ts": us(t0), "bp": "e"})

    doc: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"exporter": "repro_torch.obs.merge",
                      "processes": {p: pid for p, pid in
                                    sorted(pid_of.items())},
                      "spans": n_spans, "incomplete": n_incomplete,
                      "flows": flow_n, "cross_process_flows": n_cross,
                      "skipped_files": skipped, "dropped": dropped},
    }
    if metadata:
        doc["otherData"].update({str(k): _jsonable(v)
                                 for k, v in metadata.items()})
    return doc


def write_merged_trace(path: str, src: Union[str, Sequence[str]],
                       metadata: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Merge spill files and write the stitched trace; returns the doc."""
    doc = merge_process_traces(src, metadata)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)
