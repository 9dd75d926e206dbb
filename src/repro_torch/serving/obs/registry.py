"""Live metrics for the serving engine: a small Prometheus-style registry.

``MetricsRegistry`` holds counter/gauge/histogram families, each with
labeled children, and renders them two ways: Prometheus text exposition
(format 0.0.4 — what ``/metrics`` serves and any scraper parses) and a JSON
snapshot (what dashboards and tests consume).

The hot-path cost is zero by construction: ``instrument_engine`` registers
CALLBACK gauges that read the engine's existing ``EngineStats`` / worker
state at scrape time, so the serve loops never execute a metrics
instruction — the registry only does work when someone asks for
``render()`` / ``snapshot()``.  Counters and histograms with ``inc()`` /
``observe()`` exist for host-side consumers that want push semantics (the
scrape path is read-only and thread-safe against them: plain float/int
stores under the GIL).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace(
            '"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotone counter; ``value`` may come from a callback instead."""

    kind = "counter"

    def __init__(self, labels: Dict[str, str], fn: Optional[Callable] = None):
        self.labels = dict(labels)
        self._fn = fn
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self._value += v

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value


class Gauge(Counter):
    """Point-in-time value; ``set()`` or a scrape-time callback."""

    kind = "gauge"

    def set(self, v: float) -> None:
        self._value = float(v)


class Histogram:
    """Cumulative-bucket histogram over observed values.

    ``fn`` (optional) returns the FULL value list at scrape time — the
    pull-based form the engine instrumentation uses (per-request latencies
    already live on ``EngineStats``); ``observe()`` is the push form.
    """

    kind = "histogram"

    def __init__(self, labels: Dict[str, str],
                 buckets: Sequence[float] = _DEFAULT_BUCKETS,
                 fn: Optional[Callable] = None):
        self.labels = dict(labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._fn = fn
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        self._sum += v
        self._count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:  # per-bin counts; exposition cumulates at render
                self._counts[i] += 1
                break

    def _data(self) -> Tuple[list, float, int]:
        """(per-bin counts, sum, count) — render() cumulates the bins."""
        if self._fn is None:
            return list(self._counts), self._sum, self._count
        values = [float(v) for v in self._fn()]
        counts = [0] * len(self.buckets)
        for v in values:
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
        return counts, float(sum(values)), len(values)


class _Family:
    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.children: Dict[tuple, object] = {}

    def child_key(self, labels: Dict[str, str]) -> tuple:
        return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Named metric families with labeled children."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help_text: str) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, kind, help_text)
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"not {kind}")
        if help_text and not fam.help:
            fam.help = help_text
        return fam

    def counter(self, name: str, help_text: str = "",
                fn: Optional[Callable] = None, **labels) -> Counter:
        fam = self._family(name, "counter", help_text)
        key = fam.child_key(labels)
        if key not in fam.children:
            fam.children[key] = Counter(labels, fn=fn)
        return fam.children[key]

    def gauge(self, name: str, help_text: str = "",
              fn: Optional[Callable] = None, **labels) -> Gauge:
        fam = self._family(name, "gauge", help_text)
        key = fam.child_key(labels)
        if key not in fam.children:
            fam.children[key] = Gauge(labels, fn=fn)
        return fam.children[key]

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = _DEFAULT_BUCKETS,
                  fn: Optional[Callable] = None, **labels) -> Histogram:
        fam = self._family(name, "histogram", help_text)
        key = fam.child_key(labels)
        if key not in fam.children:
            fam.children[key] = Histogram(labels, buckets=buckets, fn=fn)
        return fam.children[key]

    # -- exposition ----------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.children):
                child = fam.children[key]
                if fam.kind == "histogram":
                    counts, total, count = child._data()
                    cum = 0
                    for b, c in zip(child.buckets, counts):
                        cum += c
                        lab = dict(child.labels, le=_fmt_value(b))
                        lines.append(
                            f"{name}_bucket{_fmt_labels(lab)} {cum}")
                    lab = dict(child.labels, le="+Inf")
                    lines.append(f"{name}_bucket{_fmt_labels(lab)} {count}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(child.labels)} "
                        f"{_fmt_value(total)}")
                    lines.append(
                        f"{name}_count{_fmt_labels(child.labels)} {count}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(child.labels)} "
                        f"{_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready view of every family/child."""
        out = {}
        for name, fam in self._families.items():
            samples = []
            for key in sorted(fam.children):
                child = fam.children[key]
                if fam.kind == "histogram":
                    counts, total, count = child._data()
                    samples.append({
                        "labels": dict(child.labels),
                        "buckets": {
                            _fmt_value(b): c
                            for b, c in zip(child.buckets, counts)},
                        "sum": total, "count": count,
                    })
                else:
                    samples.append({"labels": dict(child.labels),
                                    "value": child.value})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "samples": samples}
        return out


def instrument_engine(registry: MetricsRegistry, engine) -> MetricsRegistry:
    """Register the serving metric catalog against a live engine.

    Works on both front ends, ``ContinuousASDEngine`` (one worker) and
    ``ShardedASDEngine`` (one labelled set a worker): every metric is
    labeled by shard, and all values are read at SCRAPE time from the
    engine's existing ``EngineStats``/scheduler state (callback gauges), so
    instrumentation adds nothing to the serve loops.  The catalog is the JAX
    package's.
    """
    for w in getattr(engine, "workers", None) or [engine]:
        _instrument_worker(registry, w)
    return registry


def _instrument_worker(registry: MetricsRegistry, w) -> None:
    lab = dict(shard=str(w.shard_id))
    counters = [
        ("asd_requests_total", "requests admitted into the engine",
         lambda w: w.stats.requests),
        ("asd_retired_total", "requests completed and returned",
         lambda w: w.stats.retired),
        ("asd_dropped_total", "requests rejected at admission",
         lambda w: w.stats.dropped),
        ("asd_deferrals_total",
         "admission rounds deferred under budget pressure",
         lambda w: w.scheduler.deferred),
        ("asd_rounds_total", "fused speculation rounds driven",
         lambda w: w.stats.rounds_total),
        ("asd_supersteps_total", "device superstep dispatches",
         lambda w: w.stats.supersteps),
    ]
    for name, help_text, fn in counters:
        registry.counter(name, help_text,
                         fn=(lambda w=w, f=fn: f(w)), **lab)
    gauges = [
        ("asd_accept_rate", "speculation accept rate (engine aggregate)",
         lambda w: w.stats.accept_rate()),
        ("asd_mean_window",
         "mean live speculation window theta_live over retired chains",
         lambda w: w.stats.mean_window()),
        ("asd_budget_tier",
         "current packed verification budget tier (points per round)",
         lambda w: w.round_budget or 0),
        ("asd_queue_depth", "requests queued awaiting a slot",
         lambda w: w.scheduler.queue_depth),
        ("asd_queue_depth_peak",
         "high-watermark of the admission queue depth",
         lambda w: w.scheduler.queue_depth_peak),
        ("asd_slot_occupancy", "busy fraction of this shard's slots",
         lambda w: (w.num_slots - len(w.scheduler.free_slots()))
         / max(w.num_slots, 1)),
        ("asd_admission_pressure",
         "live verification demand over the round budget",
         lambda w: w._admission_context(0.0).budget_pressure),
        ("asd_branch_accept_depth",
         "mean accepted prefix per round over retired chains "
         "(branched speculation: deeper at B > 1 when branches help)",
         lambda w: w.stats.branch_accept_depth()),
        ("asd_wasted_draft_frac",
         "fraction of drafted verification points (all branches) that "
         "never committed — 1 - accept_rate at B = 1",
         lambda w: w.stats.wasted_draft_frac()),
        ("asd_draining", "1 while the shard is draining (no admits)",
         lambda w: int(getattr(w, "draining", False))),
    ]
    for name, help_text, fn in gauges:
        registry.gauge(name, help_text,
                       fn=(lambda w=w, f=fn: f(w)), **lab)
    # model-parallel collective time: calibrated seconds inside the
    # superstep programs (a view into their time, see EngineStats), the
    # total and its split by kind
    registry.gauge(
        "asd_collective_seconds",
        "calibrated model-parallel collective seconds inside the "
        "superstep programs (view into device time)",
        fn=(lambda w=w: w.stats.collective_s), **lab)
    for kind, field in (("psum", "collective_psum_s"),
                        ("all_to_all", "collective_a2a_s")):
        registry.gauge(
            "asd_collective_kind_seconds",
            "calibrated collective seconds by primitive kind",
            fn=(lambda w=w, f=field: getattr(w.stats, f)),
            kind=kind, **lab)
    for q in (50, 95, 99):
        registry.gauge(
            "asd_completion_latency_seconds",
            "submit -> retire latency percentiles over retired requests",
            fn=(lambda w=w, q=q:
                w.stats.latency_percentiles((q,))["completion"][f"p{q}"]),
            quantile=f"p{q}", **lab)
