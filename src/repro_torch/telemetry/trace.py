"""Flight recorder: typed, wall-clock-stamped run tracing.

Port of ``repro.telemetry.trace`` (numpy and the standard library; the
optional span annotation is ``torch.profiler.record_function``).

A :class:`RunTrace` accumulates :class:`TraceEvent` records — engine
dispatch decisions, segment/chunk spans with timings, reframe guard
evaluations and splices, chaos per-draw verdicts, build-count deltas —
from `run_scenario`, `ChaosCampaign`, and the bench harness.  The
recorder is **host-side only**: spans wrap kernel launches with
``time.perf_counter`` stamps, so tracing can never build or select a new
kernel instance (the `no_new_compiles` test pins this).

Event taxonomy (the `kind` field):

    engine_dispatch   engine lane picked + select_engine regime/stack bytes
    segment           span: one scenario segment replay
    chunk             span: one compiled chunk launch inside a segment
    guard_eval        reframe guard decision at a chunk boundary
    reframe           an applied pointer-rotation splice
    chaos_draw        one campaign draw's triage verdict
    compile_stats     build / variant counts snapshot (see compile_stats.py)
    bench             span: one benchmark lane
    mark              freeform user annotation

Export is JSON-lines (one event per line, header line first) and
round-trips through :meth:`RunTrace.from_jsonl`.  Optionally each span
also opens a ``torch.profiler.record_function`` range so chunks show up
in a ``torch.profiler`` capture (``RunTrace(annotate=True)``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["TraceEvent", "RunTrace", "NULL_TRACE", "coerce_trace"]

_SCHEMA = "bittide-run-trace/1"


def _jsonable(v: Any) -> Any:
    """Coerce numpy / torch scalars and small arrays to JSON-safe values."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "detach"):  # torch.Tensor, on any device
        v = v.detach().cpu().numpy()
    if hasattr(v, "tolist"):  # ndarray
        arr = np.asarray(v)
        if arr.size > 64:  # traces are summaries, not records
            return {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        return arr.tolist()
    return repr(v)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One record: instant event (``dur is None``) or completed span."""

    kind: str
    t: float                      # seconds since the trace epoch
    dur: Optional[float] = None   # span duration in seconds, None if instant
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        row = {"kind": self.kind, "t": round(self.t, 6)}
        if self.dur is not None:
            row["dur"] = round(self.dur, 6)
        if self.data:
            row["data"] = _jsonable(self.data)
        return json.dumps(row, sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "TraceEvent":
        row = json.loads(line)
        return cls(kind=row["kind"], t=row["t"], dur=row.get("dur"),
                   data=row.get("data", {}))


class RunTrace:
    """Accumulates trace events against one wall-clock epoch."""

    def __init__(self, name: str = "run", annotate: bool = False,
                 epoch: Optional[float] = None):
        self.name = name
        self.annotate = annotate
        self.epoch = time.time() if epoch is None else epoch
        self._t0 = time.perf_counter()
        self.events: List[TraceEvent] = []

    # ------------------------------------------------------------ recording

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def event(self, kind: str, **data: Any) -> TraceEvent:
        ev = TraceEvent(kind=kind, t=self._now(), data=data)
        self.events.append(ev)
        return ev

    @contextlib.contextmanager
    def span(self, kind: str, **data: Any):
        """Record a timed span; optionally mirrored to torch.profiler."""
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            label = data.get("name", data.get("engine", ""))
            ctx = record_function(f"{kind}:{label}" if label else kind)
        start = self._now()
        try:
            with ctx:
                yield self
        finally:
            self.events.append(TraceEvent(
                kind=kind, t=start, dur=self._now() - start, data=data))

    # ------------------------------------------------------------- querying

    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        # An EMPTY recorder is still a live recorder — never let __len__
        # drive `if trace:` instrumentation gates.
        return True

    def by_kind(self, kind: str) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == kind]

    def summary(self) -> str:
        """Per-kind table: count, total span time, worst span."""
        kinds: Dict[str, List[TraceEvent]] = {}
        for e in self.events:
            kinds.setdefault(e.kind, []).append(e)
        lines = [f"RunTrace '{self.name}': {len(self.events)} events",
                 f"{'kind':<16} {'count':>5} {'total_ms':>9} {'max_ms':>8}"]
        for kind in sorted(kinds):
            evs = kinds[kind]
            durs = [e.dur for e in evs if e.dur is not None]
            tot = f"{sum(durs) * 1e3:9.1f}" if durs else f"{'-':>9}"
            mx = f"{max(durs) * 1e3:8.1f}" if durs else f"{'-':>8}"
            lines.append(f"{kind:<16} {len(evs):>5} {tot} {mx}")
        return "\n".join(lines)

    # -------------------------------------------------------------- JSONL IO

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(json.dumps({"schema": _SCHEMA, "name": self.name,
                                 "epoch": self.epoch}) + "\n")
            for ev in self.events:
                fh.write(ev.to_json() + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "RunTrace":
        with open(path) as fh:
            lines = [ln for ln in (l.strip() for l in fh) if ln]
        if not lines:
            raise ValueError(f"{path}: empty trace file")
        head = json.loads(lines[0])
        if head.get("schema") != _SCHEMA:
            raise ValueError(f"{path}: not a {_SCHEMA} file "
                             f"(schema={head.get('schema')!r})")
        tr = cls(name=head.get("name", "run"), epoch=head.get("epoch"))
        tr.events = [TraceEvent.from_json(ln) for ln in lines[1:]]
        return tr


class _NullTrace:
    """No-op stand-in so instrumented code needs no `if trace:` litter."""

    annotate = False
    events: List[TraceEvent] = []

    def event(self, kind: str, **data: Any) -> None:
        return None

    @contextlib.contextmanager
    def span(self, kind: str, **data: Any):
        yield self

    def __bool__(self) -> bool:
        return False


NULL_TRACE = _NullTrace()


def coerce_trace(trace: Any, name: str = "run") -> Any:
    """Normalize a `trace=` argument: False->no-op, True->fresh RunTrace,
    an existing RunTrace passes through (shared across layers)."""
    if isinstance(trace, RunTrace):
        return trace
    if trace:
        return RunTrace(name=name)
    return NULL_TRACE
