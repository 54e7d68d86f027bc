"""Live telemetry plane: a process-global typed metric registry (port of
the JAX package's ``monitoring/telemetry.py``, without the cluster fleet
view, which waits for the cluster runtime).

The flight recorder (recorder.py) answers "where did query N's
wall-clock go": a bounded per-query timeline that dies with the process.
This module is the *serving* counterpart: monotonic counters, gauges and
sliding-window log-bucket histograms (p50/p95/p99) with labeled series,
scrapeable while queries are in flight. Its sources are the port's
counter funnels (the partition pipeline, the wire codec, the native
kernels' launches and library-route calls, the plan cache, the shuffle
transport, the cost model, the recovery counters of faults.py) plus direct instrumentation on the query
lifecycle (``srt_collects``, ``srt_collect_ms``, ``srt_queries``,
``srt_query_latency_ms``, the spill catalog's memory gauges).

The DISABLED path of :func:`inc` / :func:`observe` / :func:`set_gauge`
is one module-global load and a return.

Config (process-global, last collect's conf wins, as the wire codec's):
``spark.rapids.sql.metrics.enabled`` (``SRT_METRICS`` env override),
``spark.rapids.sql.metrics.port`` (the OpenMetrics exporter in
exporter.py; 0 = registry only, no socket).

Consumers: :func:`snapshot` (structured dict) and :func:`render_text`
(OpenMetrics/Prometheus text exposition: the exporter's ``/metrics``
body, readable without the socket).

Imports nothing beyond the standard library at module level, like the
recorder.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# -- process-global state -----------------------------------------------------

# THE fast-path gate: the disabled inc()/observe()/set_gauge() path
# reads this one global and returns.
_ENABLED = False

_LOCK = threading.Lock()
_METRICS: "collections.OrderedDict[str, _Metric]" = collections.OrderedDict()

# Histogram window geometry: log buckets growing by 2**(1/4) (~19% per
# bucket, so a reconstructed quantile is within ~9% of the true value),
# over a sliding window of epochs rotated by time or explicitly.
_BUCKET_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(_BUCKET_BASE)
_WINDOW_EPOCHS = 8
_ROTATE_S = 30.0

_QUANTILES = (0.5, 0.95, 0.99)


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Hist:
    """One labeled histogram series: sparse log-bucket counts over a
    sliding window (current epoch + up to window-1 rotated epochs), with
    LIFETIME count/sum (the OpenMetrics summary ``_count``/``_sum``
    monotonic pair) and window-scoped quantiles."""

    __slots__ = ("cur", "past", "count", "sum", "epoch_t0")

    def __init__(self):
        self.cur: Dict[int, int] = {}
        self.past: collections.deque = collections.deque(
            maxlen=_WINDOW_EPOCHS - 1)
        self.count = 0
        self.sum = 0.0
        self.epoch_t0 = time.monotonic()

    def observe(self, value: float, now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        if now - self.epoch_t0 >= _ROTATE_S:
            self.rotate(now)
        v = float(value)
        idx = int(math.floor(math.log(v) / _LOG_BASE)) if v > 0 else -(10**9)
        self.cur[idx] = self.cur.get(idx, 0) + 1
        self.count += 1
        self.sum += v

    def rotate(self, now: Optional[float] = None) -> None:
        """Start a new epoch; observations older than the window leave
        the quantile view (count/sum stay monotonic)."""
        self.past.append(self.cur)
        self.cur = {}
        self.epoch_t0 = time.monotonic() if now is None else now

    def _window_buckets(self) -> Dict[int, int]:
        merged = dict(self.cur)
        for epoch in self.past:
            for idx, n in epoch.items():
                merged[idx] = merged.get(idx, 0) + n
        return merged

    def quantiles(self) -> Dict[float, float]:
        buckets = self._window_buckets()
        total = sum(buckets.values())
        if total == 0:
            return {q: float("nan") for q in _QUANTILES}
        order = sorted(buckets)
        out = {}
        for q in _QUANTILES:
            target = q * total
            cum = 0
            val = 0.0
            for idx in order:
                n = buckets[idx]
                cum += n
                if cum >= target:
                    if idx <= -(10**9):
                        val = 0.0
                    else:
                        lo = _BUCKET_BASE ** idx
                        hi = _BUCKET_BASE ** (idx + 1)
                        frac = (target - (cum - n)) / n
                        val = lo + (hi - lo) * frac
                    break
            out[q] = val
        return out


class _Metric:
    __slots__ = ("name", "kind", "help", "series")

    def __init__(self, name: str, kind: str, help_: str):
        self.name = name
        self.kind = kind
        self.help = help_
        # label tuple -> float (counter/gauge) or _Hist
        self.series: Dict[tuple, object] = {}


def _metric(name: str, kind: str, help_: str = "") -> _Metric:
    """Register-on-first-use; a name keeps the kind it was born with."""
    m = _METRICS.get(name)
    if m is None:
        m = _METRICS.setdefault(name, _Metric(name, kind, help_))
    if m.kind != kind:
        raise ValueError(
            f"metric {name!r} is a {m.kind}, not a {kind}")
    if help_ and not m.help:
        m.help = help_
    return m


def describe(name: str, kind: str, help_: str) -> None:
    """Pre-register a metric's kind + help text (optional — first use
    registers too)."""
    with _LOCK:
        _metric(name, kind, help_)


# -- the recording API (hot path) ---------------------------------------------

def inc(name: str, amount: float = 1.0, **labels) -> None:
    """Increment a monotonic counter series. Disabled: one global load."""
    if not _ENABLED:
        return
    with _LOCK:
        m = _metric(name, COUNTER)
        key = _label_key(labels)
        m.series[key] = m.series.get(key, 0.0) + amount


def set_gauge(name: str, value: float, **labels) -> None:
    """Set a gauge series to ``value``. Disabled: one global load."""
    if not _ENABLED:
        return
    with _LOCK:
        m = _metric(name, GAUGE)
        m.series[_label_key(labels)] = float(value)


def max_gauge(name: str, value: float, **labels) -> None:
    """High-watermark gauge: keeps the max ever set (the spill ladder's
    device watermark). Disabled: one global load."""
    if not _ENABLED:
        return
    with _LOCK:
        m = _metric(name, GAUGE)
        key = _label_key(labels)
        prev = m.series.get(key)
        if prev is None or float(value) > prev:
            m.series[key] = float(value)


def observe(name: str, value: float, **labels) -> None:
    """Record one observation into a sliding-window log-bucket histogram
    series. Disabled: one global load."""
    if not _ENABLED:
        return
    with _LOCK:
        m = _metric(name, HISTOGRAM)
        key = _label_key(labels)
        h = m.series.get(key)
        if h is None:
            h = m.series[key] = _Hist()
        h.observe(value)


def rotate_windows() -> None:
    """Force every histogram series into a new epoch (tests drive window
    rotation deterministically through this instead of the 30 s timer)."""
    with _LOCK:
        for m in _METRICS.values():
            if m.kind == HISTOGRAM:
                for h in m.series.values():
                    h.rotate()


def enabled() -> bool:
    return _ENABLED


# -- configuration ------------------------------------------------------------

def metrics_enabled(conf=None) -> bool:
    """Conf key wins; else the SRT_METRICS env (the CI matrix hook);
    else the registered default (off)."""
    from spark_rapids_tpu_torch import config as C
    if conf is not None and conf.raw.get(C.METRICS_ENABLED.key) is not None:
        return bool(conf.get(C.METRICS_ENABLED))
    env = os.environ.get("SRT_METRICS")
    if env is not None:
        return env.strip() not in ("", "0", "false", "no")
    return bool(C.METRICS_ENABLED.default)


def maybe_configure(conf) -> None:
    """Adopt this query's telemetry configuration (process-global, last
    writer wins — the wire-codec regime). Called from the dispatch
    funnel before any instrumented site runs. Starting the exporter
    socket and the event log are side effects of turning metrics on;
    neither ever stops a running exporter (mixed-conf processes would
    flap it)."""
    global _ENABLED
    from spark_rapids_tpu_torch import config as C
    want = metrics_enabled(conf)
    if want != _ENABLED:
        _ENABLED = want
    from spark_rapids_tpu_torch.monitoring import history
    history.maybe_configure(conf)
    if not want:
        return
    port = int(conf.get(C.METRICS_PORT))
    if port > 0:
        from spark_rapids_tpu_torch.monitoring import exporter
        exporter.ensure_started(port)


def configure(enabled_: bool, port: int = 0) -> None:
    """Direct (test/bench) configuration, bypassing the conf plumbing."""
    global _ENABLED
    _ENABLED = bool(enabled_)
    if enabled_ and port > 0:
        from spark_rapids_tpu_torch.monitoring import exporter
        exporter.ensure_started(port)


def reset() -> None:
    """Drop every series (test isolation; keeps the enabled flag)."""
    with _LOCK:
        _METRICS.clear()


# -- funnel bridge ------------------------------------------------------------

# Dotted funnel counter names carry a dimension in their tail
# (``rejected.queue-full``, ``admitted.interactive``,
# ``planCacheHit.tenantA``): the base picks the label name.
_SUB_LABEL = {
    "admitted": "class", "rejected": "kind", "class": "class",
    "tenant": "tenant", "planCacheHit": "tenant", "planCacheMiss": "tenant",
}


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        elif ch.isalnum() or ch == "_":
            out.append(ch)
        else:
            out.append("_")
    s = "".join(out).strip("_")
    while "__" in s:
        s = s.replace("__", "_")
    return s


def _publish_funnel(sub: str, counters: Dict[str, float]) -> None:
    for name, value in counters.items():
        if isinstance(value, bool) or \
                not isinstance(value, (int, float)):
            continue    # funnels may expose structured diagnostics too
        base, _, tail = name.partition(".")
        metric = f"srt_{sub}_{_snake(base)}"
        m = _metric(metric, COUNTER)
        labels = {}
        if tail:
            labels[_SUB_LABEL.get(base, "sub")] = tail
        # Funnel counters are cumulative at the source: publish the
        # absolute value (set, not add) so a re-sync is idempotent.
        m.series[_label_key(labels)] = float(value)


def sync_funnels() -> None:
    """Pull every counter funnel of the port into the registry (absolute
    values, idempotent). Runs on every snapshot/render/scrape: the
    funnels stay the single source of truth; this is the exposition
    bridge. The kernel cache's funnel comes with its layer."""
    if not _ENABLED:
        return
    from spark_rapids_tpu_torch import faults as _f
    from spark_rapids_tpu_torch.columnar import wire as _w
    from spark_rapids_tpu_torch.ops import native as _n
    from spark_rapids_tpu_torch.parallel import pipeline as _p
    from spark_rapids_tpu_torch.parallel import qos as _q
    from spark_rapids_tpu_torch.parallel import scheduler as _sc
    from spark_rapids_tpu_torch.parallel import transport as _t
    from spark_rapids_tpu_torch.plan import cost as _c
    from spark_rapids_tpu_torch.plan import plan_cache as _pc
    sources = [
        ("scheduler", _sc.counters()),
        ("qos", _q.counters()),
        ("recovery", _f.counters()),
        ("transport", _t.counters()),
        ("pipeline", _p.counters()),
        ("wire", _w.counters()),
        ("native", _n.counters()),
        ("native_library", _n.library_counters()),
        ("cost", _c.counters()),
        ("plan_cache", _pc.counters()),
        ("plan_cache", {k: v for k, v in _pc.cache().stats().items()
                        if isinstance(v, (int, float))}),
    ]
    with _LOCK:
        for sub, counters in sources:
            _publish_funnel(sub, counters)


# -- consumers ----------------------------------------------------------------

def snapshot() -> dict:
    """Structured registry view (the zero-socket path). Funnels are
    synced first so the view reconciles with the subsystem counters at
    the instant of the call."""
    sync_funnels()
    out: Dict[str, dict] = {}
    with _LOCK:
        for name, m in _METRICS.items():
            series = []
            for key in sorted(m.series):
                labels = dict(key)
                if m.kind == HISTOGRAM:
                    h = m.series[key]
                    qs = h.quantiles()
                    series.append({
                        "labels": labels, "count": h.count,
                        "sum": round(h.sum, 6),
                        "p50": qs[0.5], "p95": qs[0.95], "p99": qs[0.99]})
                else:
                    series.append({"labels": labels,
                                   "value": m.series[key]})
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
    return {"enabled": _ENABLED, "metrics": out}


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels, extra=()) -> str:
    items = list(labels) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_text() -> str:
    """OpenMetrics/Prometheus text exposition: ``# TYPE`` lines, escaped
    labels, counters with a ``_total`` sample suffix, histograms as
    summaries (window quantiles + lifetime count/sum)."""
    sync_funnels()
    lines: List[str] = []
    with _LOCK:
        for name in sorted(_METRICS):
            m = _METRICS[name]
            lines.append(f"# TYPE {name} {m.kind}")
            if m.help:
                lines.append(f"# HELP {name} {_escape_label(m.help)}")
            for key in sorted(m.series):
                if m.kind == COUNTER:
                    lines.append(
                        f"{name}_total{_fmt_labels(key)} "
                        f"{_fmt_value(m.series[key])}")
                elif m.kind == GAUGE:
                    lines.append(
                        f"{name}{_fmt_labels(key)} "
                        f"{_fmt_value(m.series[key])}")
                else:
                    h = m.series[key]
                    qs = h.quantiles()
                    for q in _QUANTILES:
                        lines.append(
                            f"{name}{_fmt_labels(key, [('quantile', repr(q))])} "
                            f"{_fmt_value(qs[q])}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(key)} "
                        f"{_fmt_value(h.sum)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(key)} "
                        f"{_fmt_value(h.count)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
