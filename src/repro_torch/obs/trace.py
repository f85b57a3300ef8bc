"""Structured solve-pipeline tracing (DESIGN.md §9).

A :class:`Tracer` records **nestable spans** (timed regions: an
iteration's step, a recovery fetch, an RS decode) and **instant
events** (a persist commit with its hidden/exposed attribution, a
failure injection) with monotonic timestamps and JSON-safe labels.
Export targets:

- JSONL (:meth:`Tracer.to_jsonl` / :func:`from_jsonl`) — one record per
  line, lossless round-trip, the machine-diffable form;
- Chrome trace-event JSON (:meth:`Tracer.to_chrome`) — loadable in
  Perfetto / ``chrome://tracing`` (complete ``"X"`` events for spans,
  instant ``"i"`` events; see docs/observability.md §5).

The **disabled path is a guaranteed no-op**: :data:`NULL_TRACER` is
falsy, every method does nothing, and :meth:`NullTracer.span` returns a
cached singleton context manager — so instrumented code that guards
with ``tracer = maybe_tracer or None`` / ``if trace is not None`` (the
driver's pattern) executes **zero tracer callables and zero
allocations** on the hot path.  The guard contract is enforced by
``tests/test_obs_pipeline.py``.

Span/event *names are string literals at every call site* — the docs
freshness gate (``tools/check_docs.py``) scans ``src/`` textually for
``.span("...")`` / ``.event("...")`` and requires every name to appear
in the docs/observability.md taxonomy table.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "from_jsonl"]

_SCALARS = (str, int, bool, type(None))


def _clean(value: Any) -> Any:
    """JSON-safe label values: scalars pass through, containers are
    cleaned recursively, non-finite floats and arbitrary objects become
    repr strings (json string escaping then handles quotes, newlines,
    unicode — the label-escaping contract tested in test_obs.py)."""
    if isinstance(value, _SCALARS):
        return value
    if isinstance(value, float):
        # NaN/Inf are not valid strict JSON; Perfetto rejects them.
        return value if value == value and abs(value) != float("inf") \
            else repr(value)
    if isinstance(value, (list, tuple)):
        return [_clean(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _clean(v) for k, v in value.items()}
    return repr(value)


class _Span:
    """An open span: a reusable context manager bound to one tracer.

    Records the span *at close* (so the event list orders children
    before their parent — reconstructible through ``depth``/``ts``)."""

    __slots__ = ("_tracer", "name", "args", "_start", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._start = 0.0
        self._depth = 0

    def __enter__(self) -> "_Span":
        self._depth = self._tracer._depth
        self._tracer._depth += 1
        self._start = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = self._tracer._clock()
        self._tracer._depth -= 1
        self._tracer._record({
            "type": "span",
            "name": self.name,
            "ts": self._start - self._tracer._t0,
            "dur": end - self._start,
            "depth": self._depth,
            "args": self.args,
        })


class Tracer:
    """Span/event recorder with monotonic timestamps.

    Single-threaded by design (the driver is); timestamps come from a
    monotonic ``clock`` (``time.perf_counter`` by default — injectable
    for deterministic tests).  ``ts``/``dur`` are seconds relative to
    the tracer's construction.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._depth = 0
        self.records: List[Dict[str, Any]] = []

    def __bool__(self) -> bool:
        return True

    # -- recording ------------------------------------------------------
    def _record(self, rec: Dict[str, Any]) -> None:
        self.records.append(rec)

    def span(self, name: str, **labels: Any) -> _Span:
        """A nestable timed region: ``with tracer.span("recovery.fetch",
        blocks=(1, 2)): ...``."""
        return _Span(self, name, {k: _clean(v) for k, v in labels.items()})

    def event(self, name: str, **labels: Any) -> None:
        """An instant event at the current time and nesting depth."""
        self._record({
            "type": "event",
            "name": name,
            "ts": self._clock() - self._t0,
            "depth": self._depth,
            "args": {k: _clean(v) for k, v in labels.items()},
        })

    # -- queries --------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        """Occurrences per record name (spans and events alike) — the
        quantity the trace/report cross-check compares."""
        out: Dict[str, int] = {}
        for rec in self.records:
            out[rec["name"]] = out.get(rec["name"], 0) + 1
        return out

    def names(self) -> List[str]:
        """Distinct record names, first-seen order."""
        seen: List[str] = []
        for rec in self.records:
            if rec["name"] not in seen:
                seen.append(rec["name"])
        return seen

    # -- exports --------------------------------------------------------
    def to_jsonl(self, path) -> int:
        """One JSON object per line; lossless (:func:`from_jsonl`).
        Returns the number of records written."""
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, allow_nan=False) + "\n")
        return len(self.records)

    def to_chrome(self, path) -> int:
        """Chrome trace-event JSON (Perfetto / ``chrome://tracing``).

        Spans become complete (``"ph": "X"``) events, instants become
        ``"ph": "i"`` thread-scoped events; timestamps are microseconds
        as the format requires.  Returns the number of trace events."""
        events = []
        for rec in self.records:
            ev = {
                "name": rec["name"],
                "cat": "repro_torch",
                "ts": rec["ts"] * 1e6,
                "pid": 0,
                "tid": 0,
                "args": rec["args"],
            }
            if rec["type"] == "span":
                ev["ph"] = "X"
                ev["dur"] = rec["dur"] * 1e6
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"producer": "repro_torch.obs.trace"}}
        with open(path, "w") as f:
            json.dump(doc, f, allow_nan=False)
        return len(events)


def from_jsonl(path) -> List[Dict[str, Any]]:
    """Load records written by :meth:`Tracer.to_jsonl` (round-trip
    inverse; the export tests compare both directions)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


class _NullSpan:
    """The cached no-op context manager :meth:`NullTracer.span` returns —
    one shared instance, so the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: falsy, allocation-free, method-free on the
    hot path.  Instrumented code normalizes ``tracer or None`` once and
    guards with an identity check, so with tracing disabled no tracer
    method is ever called per iteration (the guard test's contract);
    these no-op methods exist only for callers that skip the guard."""

    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, **labels: Any) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, **labels: Any) -> None:
        return None

    def counts(self) -> Dict[str, int]:
        return {}

    def names(self) -> List[str]:
        return []

    @property
    def records(self) -> List[Dict[str, Any]]:
        return []


#: the shared disabled tracer (``SolveConfig.tracer``'s conceptual
#: default — the driver treats None and any falsy tracer identically)
NULL_TRACER = NullTracer()
