"""Labeled metrics registry for the solve pipeline (DESIGN.md §9).

Three instrument kinds, Prometheus-shaped but in-process and
allocation-light:

- :class:`Counter` — monotone integer (``recovery.absorbed``,
  ``persist.commit``);
- :class:`Gauge` — last-write-wins value (``solve.iterations``);
- :class:`Histogram` — streaming observations with exact
  count/total/min/max and percentile queries (``persist.commit_s``).

Instruments live in a :class:`MetricsRegistry`, keyed by ``(kind, name,
labels)``; registry-level *base labels* (solver, persist mode) are
joined onto every instrument, and per-instrument labels add dimensions
such as ``phase`` — the per-phase histogram table in
the reference package's ``launch.report.metrics_table`` groups on that label.

The driver's :class:`~repro_torch.solvers.driver.SolveReport` counters are
**derived views** of this registry: the solve loop increments the
registry at each site and the report's numeric fields are read back
out of it at exit, so the two cannot drift.
:func:`check_report_consistency` re-verifies the derivation and
:func:`check_trace_report` closes the triangle against the tracer's
event counts (the campaign-fuzz harness runs it for every accepted
campaign).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "check_report_consistency",
    "check_trace_report",
    "TRACE_REPORT_PAIRS",
    "SHARD_BYTE_PAIRS",
    "SERVICE_REPORT_PAIRS",
]


LabelItems = Tuple[Tuple[str, Any], ...]


def _label_key(labels: Mapping[str, Any]) -> LabelItems:
    return tuple(sorted((str(k), v) for k, v in labels.items()))


class Counter:
    """Monotone event counter."""

    kind = "counter"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelItems):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (n={n})")
        self.value += n


class Gauge:
    """Last-write-wins value."""

    kind = "gauge"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelItems):
        self.name = name
        self.labels = labels
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Streaming observations with exact summary statistics.

    Observations are kept (the pipelines observed here produce at most
    thousands of events per solve), so ``total`` accumulates in
    observation order — bit-identical to the ``+=`` accumulation the
    pre-registry report used — and percentiles are exact.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "values", "total")

    def __init__(self, name: str, labels: LabelItems):
        self.name = name
        self.labels = labels
        self.values: List[float] = []
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.values.append(float(value))
        self.total += float(value)

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def mean(self) -> float:
        return self.total / len(self.values) if self.values else float("nan")

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (nearest-rank), q in [0, 100]."""
        if not self.values:
            return float("nan")
        ordered = sorted(self.values)
        rank = max(0, math.ceil(q / 100.0 * len(ordered)) - 1)
        return ordered[min(rank, len(ordered) - 1)]

    def summary(self) -> Dict[str, float]:
        if not self.values:
            return {"count": 0, "total": 0.0}
        return {
            "count": len(self.values),
            "total": self.total,
            "mean": self.mean,
            "min": min(self.values),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "max": max(self.values),
        }


class MetricsRegistry:
    """Get-or-create registry of labeled instruments.

    ``base_labels`` (e.g. ``solver="pcg", mode="overlap"``) are joined
    onto every instrument so a sweep can merge registries without
    collisions; per-call labels add dimensions.  Asking for an existing
    ``(kind, name, labels)`` returns the same instrument; asking for an
    existing name with a *different kind* is refused (one name, one
    semantic).
    """

    def __init__(self, **base_labels: Any):
        self.base_labels = dict(base_labels)
        self._instruments: Dict[Tuple[str, LabelItems], Any] = {}
        self._kinds: Dict[str, str] = {}

    # -- instrument factories ------------------------------------------
    def _get(self, cls, name: str, labels: Mapping[str, Any]):
        known = self._kinds.get(name)
        if known is not None and known != cls.kind:
            raise ValueError(
                f"metric {name!r} is already registered as a {known}, "
                f"cannot re-register as a {cls.kind}")
        merged = dict(self.base_labels)
        merged.update(labels)
        key = (name, _label_key(merged))
        inst = self._instruments.get(key)
        if inst is None:
            inst = cls(name, _label_key(merged))
            self._instruments[key] = inst
            self._kinds[name] = cls.kind
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- views ----------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        return iter(sorted(self._instruments.values(),
                           key=lambda i: (i.name, i.labels)))

    def __len__(self) -> int:
        return len(self._instruments)

    def counter_value(self, name: str, **labels: Any) -> int:
        """The counter's value, 0 when it was never incremented (the
        derived-view read the driver uses at exit)."""
        merged = dict(self.base_labels)
        merged.update(labels)
        inst = self._instruments.get((name, _label_key(merged)))
        return 0 if inst is None else int(inst.value)

    def counter_total(self, name: str) -> int:
        """Sum of a counter over every label set it was incremented
        under — the whole-solve view of a per-shard counter such as
        ``recovery.fetch_bytes`` (0 when the name is unknown)."""
        return sum(int(inst.value) for (n, _), inst
                   in self._instruments.items()
                   if n == name and inst.kind == "counter")

    def counter_by_label(self, name: str, label: str) -> Dict[Any, int]:
        """Per-label-value breakdown of a counter, e.g.
        ``counter_by_label("persist.bytes", "shard") -> {0: ..., 1: ...}``
        (the derived view behind ``SolveReport.*_by_shard``)."""
        out: Dict[Any, int] = {}
        for (n, _), inst in self._instruments.items():
            if n != name or inst.kind != "counter":
                continue
            labels = dict(inst.labels)
            if label in labels:
                key = labels[label]
                out[key] = out.get(key, 0) + int(inst.value)
        return out

    def histogram_total(self, name: str, **labels: Any) -> float:
        merged = dict(self.base_labels)
        merged.update(labels)
        inst = self._instruments.get((name, _label_key(merged)))
        return 0.0 if inst is None else float(inst.total)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Plain-data view (JSON-ready), sorted by (name, labels)."""
        out = []
        for inst in self:
            entry: Dict[str, Any] = {
                "name": inst.name,
                "kind": inst.kind,
                "labels": dict(inst.labels),
            }
            if inst.kind == "histogram":
                entry.update(inst.summary())
            else:
                entry["value"] = inst.value
            out.append(entry)
        return out


# ----------------------------------------------------------------------
# Cross-checks (DESIGN.md §9): report == registry == trace.
# ----------------------------------------------------------------------
#: trace/metrics record name -> SolveReport field.  The fuzz harness
#: asserts these counts agree for every accepted campaign; the names
#: are the driver's literal span/event names (docs/observability.md).
TRACE_REPORT_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("recovery.absorbed", "failures_recovered"),
    ("recovery.restart", "recovery_restarts"),
    ("storage.kill", "storage_failures"),
    ("persist.commit", "persist_events"),
    ("persist.abort", "persist_aborts"),
)


#: per-shard byte counter -> (total field, by-shard dict field).  The
#: counters carry a ``shard=N`` label per device shard; the report's
#: totals and breakdowns are both derived views of them.
SHARD_BYTE_PAIRS: Tuple[Tuple[str, str, str], ...] = (
    ("persist.bytes", "persist_bytes", "persist_bytes_by_shard"),
    ("recovery.fetch_bytes", "recovery_fetch_bytes",
     "recovery_fetch_bytes_by_shard"),
)


#: service-residency counter -> SolveReport field (docs/serving.md §5).
#: Recorded in the *tenant's* registry by the solve service; zero on
#: solo driver runs, where the counters simply never increment — the
#: derived-view rule holds on both paths.
SERVICE_REPORT_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("service.wait_steps", "service_queue_wait_steps"),
    ("service.lane_steps", "service_lane_steps"),
)


def check_report_consistency(report) -> None:
    """Verify the report's counters really are views of its attached
    registry (``report.metrics``); raises ``ValueError`` naming the
    first disagreeing pair.  A report without metrics passes vacuously
    (nothing to check — e.g. a hand-built report)."""
    registry = getattr(report, "metrics", None)
    if registry is None:
        return
    for metric, field in TRACE_REPORT_PAIRS:
        got = registry.counter_value(metric)
        want = getattr(report, field)
        if got != want:
            raise ValueError(
                f"metrics/report disagreement: registry counter "
                f"{metric!r} = {got} but SolveReport.{field} = {want}")
    for metric, field in SERVICE_REPORT_PAIRS:
        got = registry.counter_value(metric)
        want = getattr(report, field, 0)
        if got != want:
            raise ValueError(
                f"metrics/report disagreement: registry counter "
                f"{metric!r} = {got} but SolveReport.{field} = {want}")
    for metric, total_field, by_shard_field in SHARD_BYTE_PAIRS:
        got_total = registry.counter_total(metric)
        want_total = getattr(report, total_field, 0)
        if got_total != want_total:
            raise ValueError(
                f"metrics/report disagreement: registry counter "
                f"{metric!r} totals {got_total} but "
                f"SolveReport.{total_field} = {want_total}")
        got_by = registry.counter_by_label(metric, "shard")
        want_by = getattr(report, by_shard_field, {})
        if got_by != want_by:
            raise ValueError(
                f"metrics/report disagreement: registry counter "
                f"{metric!r} per shard is {got_by} but "
                f"SolveReport.{by_shard_field} = {want_by}")


def check_trace_report(tracer, report) -> Dict[str, int]:
    """Verify the tracer's event counts equal the report's counters
    (and, transitively, the registry's — :func:`check_report_consistency`
    runs first).  Returns the compared ``{field: count}`` mapping;
    raises ``ValueError`` naming the first disagreement.
    """
    check_report_consistency(report)
    counts = tracer.counts()
    compared = {}
    for metric, field in TRACE_REPORT_PAIRS:
        got = counts.get(metric, 0)
        want = getattr(report, field)
        if got != want:
            raise ValueError(
                f"trace/report disagreement: {got} {metric!r} trace "
                f"events but SolveReport.{field} = {want}")
        compared[field] = got
    # Staging conservation (the stager leg of the triangle): every
    # payload a stager copied in (``stage.copy``) must leave it either
    # flushed (``stage.flush``, including drain-time flushes) or
    # explicitly discarded (``stage.abort`` carries the dropped payload
    # count) — a silent discard would make persist_aborts uncheckable
    # against the trace.
    copies = counts.get("stage.copy", 0)
    flushes = counts.get("stage.flush", 0)
    dropped = sum(
        int(rec.get("args", {}).get("count", 0))
        for rec in getattr(tracer, "records", ())
        if rec.get("type") == "event" and rec.get("name") == "stage.abort")
    if copies != flushes + dropped:
        raise ValueError(
            f"trace staging leak: {copies} stage.copy events but "
            f"{flushes} stage.flush + {dropped} payloads dropped by "
            f"stage.abort — staged payloads vanished untraced")
    compared["stage_dropped"] = dropped
    return compared
