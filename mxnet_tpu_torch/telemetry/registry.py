"""Process-wide metrics registry — Counter / Gauge / Histogram.

Counterpart of ``mxnet_tpu/telemetry/registry.py``, taken over whole:
the same families render the same exposition, byte for byte.

Reference precedent: the TensorFlow runtime's first-class metrics layer
(arxiv 1605.08695 credits runtime instrumentation for making distributed
performance debuggable) and the de-facto wire contract, the Prometheus
text exposition format (https://prometheus.io/docs/instrumenting/
exposition_formats/).  The registry is the ONE namespace every subsystem
records into — executor compiles, ndarray transfers, io stalls, kvstore
traffic, serving counters — so a single ``snapshot()`` answers "why is
this step slow".

Concurrency: every series guards its state with its own lock; the
registry guards family creation.  Families are cheap to look up
(one dict read under a lock), but hot paths should cache the returned
handle and gate on ``telemetry.enabled()`` so the disabled fast path
costs one boolean check.

Labels follow the Prometheus model: a *family* (name + type + help)
owns labeled child series; an unlabeled family proxies its mutating
API to the ``()`` child, so ``counter("x").inc()`` just works.
"""
from __future__ import annotations

import json
import math
import re
import threading
from collections import OrderedDict

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily",
           "MetricsRegistry", "exponential_buckets",
           "validate_exposition"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def exponential_buckets(start, factor, count):
    """``count`` exponentially growing upper bounds starting at
    ``start`` (the classic Prometheus helper; +Inf is implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return [start * factor ** i for i in range(count)]


class Counter:
    """Monotonically increasing series."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0   # guarded-by: _lock

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value


class Gauge:
    """Set/inc/dec series for instantaneous values (queue depth etc.)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0   # guarded-by: _lock

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        with self._lock:
            self._value -= amount

    @property
    def value(self):
        return self._value


class Histogram:
    """Cumulative histogram over fixed (typically exponential) buckets."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, bounds):
        self.bounds = sorted(float(b) for b in bounds)
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)   # guarded-by: _lock (last slot = +Inf)
        self._sum = 0.0   # guarded-by: _lock
        self._count = 0   # guarded-by: _lock
        self._exemplars = {}   # guarded-by: _lock — bucket idx -> (value, id)

    def observe(self, value, exemplar=None):
        """Record ``value``; an optional ``exemplar`` (a trace id) is
        retained per bucket for the WORST value seen there, so a slow
        histogram bucket links back to the trace that filled it."""
        value = float(value)
        i = len(self.bounds)
        for j, b in enumerate(self.bounds):
            if value <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if exemplar is not None:
                prev = self._exemplars.get(i)
                if prev is None or value > prev[0]:
                    self._exemplars[i] = (value, str(exemplar))

    def exemplars(self):
        """``{le: {"value": v, "trace": id}}`` — worst exemplar per
        bucket (exposed via snapshot(), NOT prometheus_text: the 0.0.4
        text format has no exemplar syntax and the validator is strict)."""
        with self._lock:
            ex = dict(self._exemplars)
        out = {}
        for i, (v, tid) in ex.items():
            le = self.bounds[i] if i < len(self.bounds) else math.inf
            out["+Inf" if math.isinf(le) else le] = {
                "value": v, "trace": tid}
        return out

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def buckets(self):
        """Cumulative ``[(le, count), ...]`` ending with ``(inf, count)``."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


OVERFLOW_LABEL = "__overflow__"


class MetricFamily:
    """name + type + help owning labeled child series.

    Cardinality: ``max_children`` (installed by the registry from
    ``MXNET_TELEMETRY_LABEL_CAP``) caps distinct label sets per family —
    per-tenant/per-model labels are attacker-sized otherwise.  Past the
    cap, novel label sets collapse into one shared child whose every
    label value is ``__overflow__``, and ``on_overflow`` (the registry's
    spill counter) fires once per spilled set."""

    def __init__(self, name, kind, help="", child_factory=None,
                 max_children=0, on_overflow=None):
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        self.name = name
        self.kind = kind
        self.help = help
        self._factory = child_factory
        self._max = int(max_children or 0)
        self._on_overflow = on_overflow
        self._lock = threading.Lock()
        self._children = OrderedDict()   # guarded-by: _lock

    def labels(self, **labels):
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError("invalid label name %r" % k)
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        spilled = False
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self._max and key and len(self._children) >= self._max:
                    spilled = True
                    key = tuple((k, OVERFLOW_LABEL) for k, _v in key)
                    child = self._children.get(key)
                if child is None:
                    child = self._factory()
                    self._children[key] = child
        if spilled and self._on_overflow is not None:
            # outside _lock: the spill counter is another family whose
            # labels() we must not call re-entrantly
            self._on_overflow(self.name)
        return child

    def items(self):
        """``[(labels_dict, series), ...]`` snapshot of the children."""
        with self._lock:
            return [(dict(k), c) for k, c in self._children.items()]

    # -- unlabeled convenience: proxy to the () child -----------------------
    def _default(self):
        return self.labels()

    def inc(self, amount=1):
        self._default().inc(amount)

    def dec(self, amount=1):
        self._default().dec(amount)

    def set(self, value):
        self._default().set(value)

    def observe(self, value, exemplar=None):
        self._default().observe(value, exemplar=exemplar)

    def exemplars(self):
        return self._default().exemplars()

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    def buckets(self):
        return self._default().buckets()

    def total(self):
        """Sum of all children's scalar values (counter/gauge only)."""
        return sum(c.value for _, c in self.items())


# default latency buckets: 10 µs .. ~84 s, factor 4
_DEFAULT_BUCKETS = exponential_buckets(1e-5, 4.0, 12)


_OVERFLOW_TOTAL = "mxnet_telemetry_label_overflow_total"


class MetricsRegistry:
    """Thread-safe family registry with JSON and Prometheus views."""

    def __init__(self, label_cap=0):
        self._lock = threading.Lock()
        self._families = OrderedDict()   # guarded-by: _lock
        self._generation = 0             # guarded-by: _lock
        self._label_cap = int(label_cap or 0)   # guarded-by: _lock

    def set_label_cap(self, cap):
        """Install the per-family label-cardinality cap (0 = uncapped);
        applies to existing families too."""
        with self._lock:
            self._label_cap = int(cap or 0)
            for fam in self._families.values():
                if fam.name != _OVERFLOW_TOTAL:
                    fam._max = self._label_cap
                    fam._on_overflow = self._record_overflow

    def _record_overflow(self, family_name):
        """One spill counted per label set collapsed into the overflow
        child.  Bounded: one series per family name, and the spill
        counter itself is exempt from the cap (no recursion)."""
        self.counter(_OVERFLOW_TOTAL,
                     "label sets collapsed into the __overflow__ child "
                     "by MXNET_TELEMETRY_LABEL_CAP, by metric family"
                     ).labels(metric=family_name).inc()

    def _get_or_create(self, name, kind, help, factory):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        "metric %r already registered as %s, not %s"
                        % (name, fam.kind, kind))
                return fam
            cap = 0 if name == _OVERFLOW_TOTAL else self._label_cap
            fam = MetricFamily(name, kind, help, factory,
                               max_children=cap,
                               on_overflow=None if name == _OVERFLOW_TOTAL
                               else self._record_overflow)
            self._families[name] = fam
            return fam

    def counter(self, name, help=""):
        return self._get_or_create(name, "counter", help, Counter)

    def gauge(self, name, help=""):
        return self._get_or_create(name, "gauge", help, Gauge)

    def histogram(self, name, help="", buckets=None):
        bounds = list(buckets) if buckets is not None else _DEFAULT_BUCKETS
        return self._get_or_create(name, "histogram", help,
                                   lambda: Histogram(bounds))

    def families(self):
        with self._lock:
            return list(self._families.values())

    @property
    def generation(self):
        """Bumped by ``reset()`` — hot paths cache (generation, handle)
        pairs so a cached family handle never outlives its registry."""
        return self._generation

    def reset(self):
        """Drop every family (tests / fresh measurement windows).

        Caveat: objects holding family handles across a reset (a live
        ``ModelServer``'s mirrors, a cached hot-path handle) keep
        recording into the dropped families, invisible to snapshot();
        generation-checked caches re-resolve, and serving ``stats()``
        reads its own per-instance counts either way — but reset while
        servers are live leaves the ``mxnet_serving_*`` mirrors stale
        until the next server is constructed."""
        with self._lock:
            self._families.clear()
            self._generation += 1

    def scalar_totals(self):
        """``{name: total}`` over counter/gauge families (the chrome-trace
        'C'-event feed and the step logger's delta source)."""
        out = OrderedDict()
        for fam in self.families():
            if fam.kind in ("counter", "gauge"):
                out[fam.name] = fam.total()
        return out

    # -- views ---------------------------------------------------------------
    def snapshot(self):
        """JSON-serializable view of every series."""
        snap = OrderedDict()
        for fam in self.families():
            values = []
            for labels, child in fam.items():
                if fam.kind == "histogram":
                    row = {
                        "labels": labels,
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": [["+Inf" if math.isinf(le) else le, c]
                                    for le, c in child.buckets()],
                    }
                    ex = child.exemplars()
                    if ex:
                        row["exemplars"] = ex
                    values.append(row)
                else:
                    values.append({"labels": labels, "value": child.value})
            snap[fam.name] = {"type": fam.kind, "help": fam.help,
                              "values": values}
        return snap

    def snapshot_json(self, **kwargs):
        return json.dumps(self.snapshot(), **kwargs)

    def prometheus_text(self):
        """Prometheus text exposition (format version 0.0.4)."""
        lines = []
        for fam in self.families():
            if fam.help:
                lines.append("# HELP %s %s"
                             % (fam.name, _escape_help(fam.help)))
            lines.append("# TYPE %s %s" % (fam.name, fam.kind))
            for labels, child in fam.items():
                if fam.kind == "histogram":
                    for le, c in child.buckets():
                        lines.append("%s_bucket%s %d" % (
                            fam.name,
                            _label_str(labels, extra=("le", _fmt_le(le))),
                            c))
                    lines.append("%s_sum%s %s" % (
                        fam.name, _label_str(labels), _fmt_num(child.sum)))
                    lines.append("%s_count%s %d" % (
                        fam.name, _label_str(labels), child.count))
                else:
                    lines.append("%s%s %s" % (
                        fam.name, _label_str(labels),
                        _fmt_num(child.value)))
        return "\n".join(lines) + "\n"


def _escape_help(s):
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s):
    return (str(s).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels, extra=None):
    parts = ['%s="%s"' % (k, _escape_label(v))
             for k, v in sorted(labels.items())]
    if extra is not None:
        parts.append('%s="%s"' % (extra[0], extra[1]))
    return "{%s}" % ",".join(parts) if parts else ""


def _fmt_le(le):
    return "+Inf" if math.isinf(le) else repr(float(le))


def _fmt_num(v):
    f = float(v)
    if f == int(f) and abs(f) < 1e15 and not math.isinf(f):
        return str(int(f))
    return repr(f)


# ---------------------------------------------------------------------------
# exposition validity check — the acceptance's "round-trips through a
# format-validity test".  A strict-enough parser for the subset this
# registry emits: every sample line must scan, every metric must carry a
# TYPE, histograms must be cumulative with a terminal +Inf == _count.
# ---------------------------------------------------------------------------
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r" (?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$")
_LABEL_PAIR_RE = re.compile(
    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"$')


def validate_exposition(text):
    """Raise ``ValueError`` unless ``text`` is a well-formed Prometheus
    text exposition; returns the parsed ``{series_name: [(labels_str,
    value)]}`` map on success."""
    typed = {}
    samples = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError("line %d: bad TYPE line %r" % (lineno, line))
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError("line %d: unparseable sample %r"
                             % (lineno, line))
        labels = m.group("labels")
        if labels:
            body = labels[1:-1]
            for pair in _split_label_pairs(body):
                if not _LABEL_PAIR_RE.match(pair):
                    raise ValueError("line %d: bad label pair %r"
                                     % (lineno, pair))
        samples.setdefault(m.group("name"), []).append(
            (labels or "", m.group("value")))
    for name in samples:
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            raise ValueError("metric %r has no # TYPE line" % name)
    # histogram invariants: cumulative buckets, +Inf present and == count
    for name, kind in typed.items():
        if kind != "histogram":
            continue
        counts = [int(float(v)) for _l, v in samples.get(name + "_count", [])]
        series = {}
        for lbl, v in samples.get(name + "_bucket", []):
            mle = re.search(r'le="([^"]+)"', lbl)
            if not mle:
                raise ValueError("histogram %r bucket without le" % name)
            key = re.sub(r',?le="[^"]+"', "", lbl)
            series.setdefault(key, []).append((mle.group(1), int(float(v))))
        for key, rows in series.items():
            vals = [c for _le, c in rows]
            if vals != sorted(vals):
                raise ValueError("histogram %r buckets not cumulative" % name)
            les = [le for le, _c in rows]
            if "+Inf" not in les:
                raise ValueError("histogram %r missing +Inf bucket" % name)
            if counts and rows[-1][1] not in counts:
                raise ValueError(
                    "histogram %r +Inf bucket disagrees with _count" % name)
    return samples


def _split_label_pairs(body):
    """Split ``k="v",k2="v2"`` respecting escaped quotes."""
    pairs, cur, in_str, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\" and in_str:
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_str = not in_str
            cur.append(ch)
            continue
        if ch == "," and not in_str:
            pairs.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        pairs.append("".join(cur))
    return [p for p in pairs if p]
