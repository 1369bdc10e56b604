"""MetricsRegistry — the one place runtime counters live (DESIGN §13).

Before this layer, every subsystem kept its own ad-hoc stats dict
(planner ``cache_stats()``, store ``write_stats()``/``io_stats``, serving
``stats()``, the device ShufflePlan trace counter).  They still exist as
*views*, but the storage — or, for stats whose internal representation is
load-bearing (the store's fold-on-eviction write log), a snapshot
callback — is consolidated here so one call exports everything:

* :meth:`MetricsRegistry.snapshot` — versioned JSON document
  (``{"version": 1, "metrics": {...}}``), the machine-readable surface
  ``session.metrics()``/``frontend.metrics()`` return.
* :meth:`MetricsRegistry.prometheus_text` — Prometheus text exposition
  (``# TYPE``/``# HELP`` + samples), scrape-ready.

Instruments are **counters** (monotone), **gauges** (set/add) and
**fixed-bucket histograms** (cumulative ``le`` buckets + sum + count).
All are thread-safe with one tiny per-instrument lock held only around
the numeric update — no global lock on any hot path.  Same
``(name, labels)`` always resolves to the same instrument, so components
re-created per session (planners, frontends) attribute their series with
an instance label instead of colliding.

Callbacks (:meth:`register_callback`) contribute computed samples at
snapshot time; registrants are held by weakref so short-lived owners
(a test's Session) never pin or pollute the registry after death.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "METRICS_SCHEMA_VERSION", "validate_snapshot",
           "DEFAULT_BUCKETS", "merge_node_snapshots",
           "snapshot_prometheus_text", "parse_prometheus_text"]

#: schema version stamped into every JSON snapshot; loaders must tolerate
#: (skip + report) documents from a future version
METRICS_SCHEMA_VERSION = 1

#: latency-ish default buckets (seconds): 100µs … 10s, log-spaced
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0,
                   10.0)

Labels = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, str]]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Common shell: identity + its own cheap lock."""

    kind = "untyped"

    def __init__(self, name: str, labels: Labels, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()

    @property
    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(_Instrument):
    """Monotone counter.  ``inc()`` only; decrements raise."""

    kind = "counter"

    def __init__(self, name: str, labels: Labels, help: str = ""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (v={v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> Iterable[Tuple[str, Labels, float]]:
        yield self.name, self.labels, self.value


class Gauge(_Instrument):
    """Point-in-time value: ``set()`` / ``add()`` (either direction)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Labels, help: str = ""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> Iterable[Tuple[str, Labels, float]]:
        yield self.name, self.labels, self.value


class Histogram(_Instrument):
    """Fixed-bucket histogram (Prometheus classic shape): per-bucket
    cumulative counts over static upper bounds, plus sum and count."""

    kind = "histogram"

    def __init__(self, name: str, labels: Labels, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, labels, help)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)       # +inf tail bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # linear scan: bucket lists are short (~12) and the loop is inside
        # the per-instrument lock for exact concurrent totals
        with self._lock:
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, out = 0, []
        for b, n in zip(self.buckets, counts[:-1]):
            cum += n
            out.append((b, cum))
        return {"buckets": out, "inf": c, "sum": s, "count": c}

    def samples(self) -> Iterable[Tuple[str, Labels, float]]:
        snap = self.snapshot()
        for b, cum in snap["buckets"]:
            yield (self.name + "_bucket",
                   self.labels + (("le", _fmt_float(b)),), float(cum))
        yield (self.name + "_bucket", self.labels + (("le", "+Inf"),),
               float(snap["inf"]))
        yield self.name + "_sum", self.labels, float(snap["sum"])
        yield self.name + "_count", self.labels, float(snap["count"])


def _fmt_float(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Get-or-create instrument registry + exporters."""

    def __init__(self):
        self._instruments: Dict[Tuple[str, Labels], _Instrument] = {}
        self._lock = threading.Lock()            # registration only
        # weakref'd (owner, fn) callbacks: fn(owner) -> iterable of
        # (name, labels-dict, value) computed samples
        self._callbacks: List[Tuple[weakref.ref, Callable]] = []

    # -- registration --------------------------------------------------------
    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             help: str, **kw) -> _Instrument:
        key = (name, _labels_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1], help=help, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, labels, help, buckets=buckets)

    def register_callback(self, owner: Any, fn: Callable) -> None:
        """Contribute computed samples at snapshot time: ``fn(owner)``
        yields ``(name, labels_dict, value)``.  ``owner`` is weakly held —
        when it dies the callback silently disappears."""
        with self._lock:
            self._callbacks.append((weakref.ref(owner), fn))

    # -- collection ----------------------------------------------------------
    def _collect(self) -> List[Tuple[str, Labels, float, str, str]]:
        """All samples: (name, labels, value, kind, help)."""
        with self._lock:
            instruments = list(self._instruments.values())
            callbacks = list(self._callbacks)
        out = []
        for inst in instruments:
            for name, labels, value in inst.samples():
                out.append((name, labels, value, inst.kind, inst.help))
        dead = False
        for ref, fn in callbacks:
            owner = ref()
            if owner is None:
                dead = True
                continue
            try:
                for name, labels, value in fn(owner):
                    out.append((name, _labels_key(labels), float(value),
                                "gauge", ""))
            except Exception:       # noqa: BLE001 — a broken callback must
                continue            # never take down a metrics scrape
        if dead:
            with self._lock:
                self._callbacks = [(r, f) for r, f in self._callbacks
                                   if r() is not None]
        return out

    # -- exporters -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Versioned JSON document of every sample (the
        ``session.metrics()`` payload)."""
        metrics: Dict[str, Any] = {}
        for name, labels, value, kind, _help in sorted(self._collect()):
            series = metrics.setdefault(name, {"type": kind, "samples": []})
            series["samples"].append({"labels": dict(labels),
                                      "value": value})
        return {"version": METRICS_SCHEMA_VERSION,
                "generated_unix_s": time.time(),
                "metrics": metrics}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, one block per metric name."""
        by_name: Dict[str, List] = {}
        meta: Dict[str, Tuple[str, str]] = {}
        for name, labels, value, kind, help in self._collect():
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if kind == "histogram" and name.endswith(suffix):
                    base = name[:-len(suffix)]
                    break
            by_name.setdefault(base, []).append((name, labels, value))
            meta.setdefault(base, (kind, help))
        lines: List[str] = []
        for base in sorted(by_name):
            kind, help = meta[base]
            if help:
                lines.append(f"# HELP {base} {help}")
            lines.append(f"# TYPE {base} {kind}")
            # keep each instrument's native sample order — histogram
            # buckets must stay le-ascending with +Inf last, which a
            # lexicographic sort would scramble
            for name, labels, value in by_name[base]:
                if labels:
                    lab = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
                    lines.append(f"{name}{{{lab}}} {_fmt_value(value)}")
                else:
                    lines.append(f"{name} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def write_snapshot(self, path: str) -> Dict[str, Any]:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        return snap

    # -- maintenance ---------------------------------------------------------
    def reset(self) -> None:
        """Drop every instrument and callback (tests)."""
        with self._lock:
            self._instruments.clear()
            self._callbacks.clear()


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def validate_snapshot(snap: Dict[str, Any]) -> Tuple[bool, str]:
    """Loader-side schema check for a metrics JSON snapshot: known
    versions pass; an unknown (newer) version is *reported*, not fatal —
    callers decide whether to best-effort parse."""
    v = snap.get("version")
    if v is None:
        return False, "snapshot has no 'version' field"
    if int(v) > METRICS_SCHEMA_VERSION:
        return False, (f"snapshot version {v} is newer than supported "
                       f"{METRICS_SCHEMA_VERSION}; fields may be missing")
    return True, ""


# ---------------------------------------------------------------------------
# cluster metrics aggregation (DESIGN §15): merge per-node JSON snapshots
# into one node-labeled view, render any snapshot as Prometheus text, and
# strictly parse that text back (the round-trip contract tests pin).
# ---------------------------------------------------------------------------

def merge_node_snapshots(by_node: Dict[str, Dict[str, Any]]
                         ) -> Dict[str, Any]:
    """Merge per-node metrics snapshots into ONE snapshot document where
    every sample carries a ``node`` label.  Future-version snapshots are
    skipped (reported under ``skipped_nodes``), matching the tolerant
    loader contract everywhere else."""
    merged: Dict[str, Any] = {}
    skipped: List[str] = []
    for node in sorted(by_node):
        snap = by_node[node]
        ok, _why = validate_snapshot(snap)
        if not ok:
            skipped.append(node)
            continue
        for name, series in snap.get("metrics", {}).items():
            out = merged.setdefault(
                name, {"type": series.get("type", "untyped"), "samples": []})
            for s in series.get("samples", []):
                labels = dict(s.get("labels", {}))
                labels["node"] = node
                out["samples"].append({"labels": labels,
                                       "value": s.get("value", 0.0)})
    doc: Dict[str, Any] = {"version": METRICS_SCHEMA_VERSION,
                           "generated_unix_s": time.time(),
                           "nodes": sorted(set(by_node) - set(skipped)),
                           "metrics": merged}
    if skipped:
        doc["skipped_nodes"] = skipped
    return doc


def _le_sort_key(labels: Dict[str, str]):
    le = labels.get("le", "")
    v = float("inf") if le == "+Inf" else float(le)
    return v


def snapshot_prometheus_text(snap: Dict[str, Any]) -> str:
    """Render a metrics JSON snapshot (live or merged) as Prometheus text.

    The JSON snapshot sorts samples lexicographically, which scrambles
    histogram bucket order (``"+Inf" < "0.001"`` as strings) — this
    renderer re-groups buckets per label set and re-sorts ``le``
    numerically with ``+Inf`` last, so the text output honors the
    exposition-format ordering contract regardless of source order."""
    ok, why = validate_snapshot(snap)
    if not ok:
        raise ValueError(f"cannot render snapshot: {why}")
    metrics = snap.get("metrics", {})
    # group histogram series (name_bucket/_sum/_count) under their base
    bases: Dict[str, Dict[str, Any]] = {}
    for name, series in metrics.items():
        base = name
        if series.get("type") == "histogram":
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix):
                    base = name[:-len(suffix)]
                    break
        entry = bases.setdefault(base, {"type": series.get("type",
                                                           "untyped"),
                                        "series": {}})
        entry["series"][name] = series
    lines: List[str] = []
    for base in sorted(bases):
        entry = bases[base]
        kind = entry["type"]
        lines.append(f"# TYPE {base} {kind}")
        if kind == "histogram":
            _render_histogram(lines, base, entry["series"])
            continue
        for name in sorted(entry["series"]):
            samples = entry["series"][name].get("samples", [])
            for s in sorted(samples,
                            key=lambda s: sorted(s.get("labels",
                                                       {}).items())):
                lines.append(_sample_line(name, s.get("labels", {}),
                                          s.get("value", 0.0)))
    return "\n".join(lines) + "\n"


def _render_histogram(lines: List[str], base: str,
                      series: Dict[str, Any]) -> None:
    buckets = series.get(base + "_bucket", {}).get("samples", [])
    sums = series.get(base + "_sum", {}).get("samples", [])
    counts = series.get(base + "_count", {}).get("samples", [])

    def group_key(s):
        return tuple(sorted((k, v) for k, v in s.get("labels", {}).items()
                            if k != "le"))

    groups: Dict[Tuple, List] = {}
    for s in buckets:
        groups.setdefault(group_key(s), []).append(s)
    by_key_sum = {group_key(s): s for s in sums}
    by_key_count = {group_key(s): s for s in counts}
    for key in sorted(groups):
        for s in sorted(groups[key], key=lambda s: _le_sort_key(
                s.get("labels", {}))):
            lines.append(_sample_line(base + "_bucket",
                                      s.get("labels", {}),
                                      s.get("value", 0.0)))
        if key in by_key_sum:
            s = by_key_sum[key]
            lines.append(_sample_line(base + "_sum", s.get("labels", {}),
                                      s.get("value", 0.0)))
        if key in by_key_count:
            s = by_key_count[key]
            lines.append(_sample_line(base + "_count", s.get("labels", {}),
                                      s.get("value", 0.0)))


def _sample_line(name: str, labels: Dict[str, str], value: Any) -> str:
    if labels:
        lab = ",".join(f'{k}="{_escape(str(v))}"'
                       for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}} {_fmt_value(float(value))}"
    return f"{name} {_fmt_value(float(value))}"


def _unescape(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ValueError(f"bad escape \\{nxt} in label value {v!r}")
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(body: str) -> Dict[str, str]:
    """Parse the ``{k="v",...}`` body with full escape handling."""
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        j = body.index("=", i)
        key = body[i:j].strip()
        if not key or not key.replace("_", "a").isalnum():
            raise ValueError(f"bad label name {key!r}")
        if j + 1 >= n or body[j + 1] != '"':
            raise ValueError(f"label {key!r} value is not quoted")
        k = j + 2
        raw: List[str] = []
        while k < n:
            c = body[k]
            if c == "\\":
                raw.append(body[k:k + 2])
                k += 2
                continue
            if c == '"':
                break
            raw.append(c)
            k += 1
        else:
            raise ValueError("unterminated label value")
        if key in labels:
            raise ValueError(f"duplicate label {key!r}")
        labels[key] = _unescape("".join(raw))
        i = k + 1
        if i < n:
            if body[i] != ",":
                raise ValueError(f"expected ',' at {body[i:]!r}")
            i += 1
    return labels


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Strict parser for the text exposition format.  Returns
    ``{"types": {base: kind}, "samples": [(name, labels, value)]}`` and
    raises ``ValueError`` on any violation of the contract our emitters
    promise: parseable sample lines, a ``# TYPE`` line preceding each
    metric's samples, no duplicate ``(name, labels)`` sample, histogram
    buckets in ascending ``le`` order with ``+Inf`` last and a bucket
    count matching ``_count`` per label set."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    seen: set = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {lineno}: malformed TYPE line")
            _h, _t, base, kind = parts
            if base in types:
                raise ValueError(f"line {lineno}: duplicate TYPE {base}")
            if kind not in ("counter", "gauge", "histogram", "untyped"):
                raise ValueError(f"line {lineno}: unknown kind {kind!r}")
            types[base] = kind
            continue
        if line.startswith("#"):
            continue                           # HELP / comments
        # sample line: name{labels} value  |  name value
        if "{" in line:
            name, rest = line.split("{", 1)
            body, tail = rest.rsplit("}", 1)
            labels = _parse_labels(body)
            value_str = tail.strip()
        else:
            try:
                name, value_str = line.rsplit(None, 1)
            except ValueError:
                raise ValueError(f"line {lineno}: malformed sample "
                                 f"{line!r}") from None
            labels = {}
        name = name.strip()
        if not name or not name.replace("_", "a").replace(":",
                                                          "a").isalnum():
            raise ValueError(f"line {lineno}: bad metric name {name!r}")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types \
                    and types[name[:-len(suffix)]] == "histogram":
                base = name[:-len(suffix)]
                break
        if base not in types:
            raise ValueError(f"line {lineno}: sample {name!r} has no "
                             f"preceding # TYPE line")
        if value_str == "+Inf":
            value = float("inf")
        else:
            value = float(value_str)
        key = (name, tuple(sorted(labels.items())))
        if key in seen:
            raise ValueError(f"line {lineno}: duplicate sample {key}")
        seen.add(key)
        samples.append((name, labels, value))
    _check_histograms(types, samples)
    return {"types": types, "samples": samples}


def _check_histograms(types: Dict[str, str],
                      samples: List[Tuple[str, Dict[str, str], float]]
                      ) -> None:
    for base, kind in types.items():
        if kind != "histogram":
            continue
        groups: Dict[Tuple, List[Tuple[str, float]]] = {}
        counts: Dict[Tuple, float] = {}
        for name, labels, value in samples:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            if name == base + "_bucket":
                groups.setdefault(key, []).append(
                    (labels.get("le", ""), value))
            elif name == base + "_count":
                counts[key] = value
        for key, rows in groups.items():
            les = [float("inf") if le == "+Inf" else float(le)
                   for le, _ in rows]
            if les != sorted(les) or len(set(les)) != len(les):
                raise ValueError(
                    f"{base}{dict(key)}: buckets not in ascending le order")
            if not les or les[-1] != float("inf"):
                raise ValueError(f"{base}{dict(key)}: +Inf bucket missing "
                                 "or not last")
            cums = [v for _, v in rows]
            if cums != sorted(cums):
                raise ValueError(f"{base}{dict(key)}: bucket counts not "
                                 "cumulative")
            if key in counts and counts[key] != cums[-1]:
                raise ValueError(f"{base}{dict(key)}: _count "
                                 f"{counts[key]} != +Inf bucket {cums[-1]}")


#: the process-global default registry (Sessions/Frontends use it unless
#: constructed with their own)
REGISTRY = MetricsRegistry()
