"""Request-scoped tracing: spans, wire context, head+tail sampling.

Reference analog: common/utils/Tracing.h:12-72 — TRACING_ADD_EVENT appends
(timestamp, event) points to a folly::RequestContext-scoped buffer; the
points ride with the request across executor hops.  This module grows that
into Dapper-style distributed spans: a contextvar carries the active Span
across awaits in the same task tree, `Client.call`/`post` stamp
(trace_id, parent_span_id, sampled) onto the MessagePacket envelope, and
server dispatch reopens the context on the far side — so one trace_id
follows a CRAQ write head→mid→tail.

Sampling is two-stage:
  * head: `TraceConfig.sample_rate` decides at the root (start_root)
    whether a request records at all; unsampled requests do zero work and
    ship zero extra envelope state (the serde defaults).
  * tail: every process buffers its finished spans per-trace in a bounded
    SpanBuffer; when the LOCAL ROOT of a trace finishes (the span whose
    parent came over the wire, or a true root), the trace is promoted to
    the export queue iff it was slow (per-method threshold) or any of its
    spans errored — otherwise it expires.  Promoted spans drain through
    MonitorReporter into the monitor_collector `spans` table.

Span lifecycle is context-managed (`with span(...)` / `with
start_root(...)`); bare `Span(...)` construction outside this module is a
t3fslint `span-not-closed` finding.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from t3fs_torch.utils.config import ConfigBase, cchoice, citem

_points: contextvars.ContextVar["Points | None"] = contextvars.ContextVar(
    "t3fs_trace_points", default=None)
_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "t3fs_trace_span", default=None)


# ---------------------------------------------------------------- config

@dataclass
class TraceConfig(ConfigBase):
    """Tracing knobs; all hot (configure() re-reads them live)."""
    # head sampling: fraction of roots that record (0 = tracing off)
    sample_rate: float = citem(0.0, validator=lambda v: 0.0 <= v <= 1.0)
    # tail = export only slow/errored traces; all = export every sampled one
    export: str = citem("tail", validator=cchoice("tail", "all"))
    # local-root latency above this promotes the trace (tail sampling)
    slow_ms: float = citem(100.0, validator=lambda v: v >= 0)
    # per-method overrides: "Storage.update=50,Meta.open=20" (ms)
    slow_ms_by_method: str = citem("")
    # bounds: total buffered spans / spans per trace / undecided-trace TTL
    max_spans: int = citem(8192, validator=lambda v: v > 0)
    max_trace_spans: int = citem(256, validator=lambda v: v > 0)
    trace_ttl_s: float = citem(30.0, validator=lambda v: v > 0)
    # export queue cap (drained by MonitorReporter; overflow drops oldest)
    export_max: int = citem(4096, validator=lambda v: v > 0)


_cfg = TraceConfig()
_slow_by_method: dict[str, float] = {}


def configure(cfg: TraceConfig) -> None:
    """Install cfg process-wide (idempotent; hot-update safe)."""
    global _cfg, _slow_by_method
    by_method: dict[str, float] = {}
    for part in cfg.slow_ms_by_method.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, ms = part.partition("=")
        try:
            by_method[name.strip()] = float(ms) / 1000.0
        except ValueError:
            continue
    _cfg = cfg
    _slow_by_method = by_method


def get_config() -> TraceConfig:
    return _cfg


def _slow_s(method: str) -> float:
    return _slow_by_method.get(method, _cfg.slow_ms / 1000.0)


def _new_id() -> int:
    # 63-bit so the id survives sqlite INTEGER and JSON round-trips signed
    return random.getrandbits(63) | 1


# ----------------------------------------------------------------- spans

@dataclass
class Span:
    """One timed operation in a trace.  Construct via span()/start_root()/
    start_span()/server_scope(), never directly (t3fslint span-not-closed)."""
    trace_id: int = 0
    span_id: int = 0
    parent_id: int = 0
    name: str = ""
    kind: str = "local"           # local | client | server
    t0: float = field(default_factory=time.time)
    dur_s: float = 0.0
    status: int = 0               # StatusCode int; 0 = OK
    tags: dict[str, Any] = field(default_factory=dict)
    events: list[tuple[float, str, str]] = field(default_factory=list)
    # parent lives on another node: this span is the trace's LOCAL root,
    # whose finish() triggers the tail-sampling decision here
    remote_parent: bool = False

    def __post_init__(self) -> None:
        self._m0 = time.perf_counter()
        self._finished = False

    def add_event(self, event: str, detail: str = "") -> None:
        self.events.append((time.perf_counter() - self._m0, event, str(detail)))

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def set_status(self, code: int) -> None:
        if self.status == 0:
            self.status = int(code)

    @property
    def is_local_root(self) -> bool:
        return self.remote_parent or self.parent_id == 0

    def finish(self) -> None:
        """Close the span and hand it to the process SpanBuffer.  Idempotent
        (a with-block exit after a manual finish is a no-op)."""
        if self._finished:
            return
        self._finished = True
        self.dur_s = time.perf_counter() - self._m0
        BUFFER.on_finish(self)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "kind": self.kind, "t0": self.t0, "dur_s": self.dur_s,
            "status": self.status, "tags": self.tags,
            "events": [list(e) for e in self.events],
            "root": self.is_local_root,
        }


class _NullSpan:
    """No-op stand-in yielded by scopes when the request is unsampled, so
    call sites can tag/event unconditionally."""
    trace_id = 0
    span_id = 0
    status = 0

    def add_event(self, event: str, detail: str = "") -> None:
        pass

    def set_tag(self, key: str, value: Any) -> None:
        pass

    def set_status(self, code: int) -> None:
        pass

    def finish(self) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _SpanScope:
    """Context manager owning one span's contextvar window.  Restores the
    OUTER span via the contextvar token (never set(None)) so nested scopes
    — a ckpt restore issuing kvcache reads — keep the outer trace."""

    __slots__ = ("span", "_token")

    def __init__(self, span: Span | None):
        self.span = span
        self._token: contextvars.Token | None = None

    def __enter__(self):
        if self.span is not None:
            self._token = _current.set(self.span)
            return self.span
        return NULL_SPAN

    def __exit__(self, et, ev, tb) -> bool:
        if self.span is not None:
            if et is not None and self.span.status == 0:
                st = getattr(ev, "status", None)
                code = getattr(st, "code", None)
                self.span.status = int(code) if code is not None else 1
            _current.reset(self._token)
            self.span.finish()
        return False


def current_span() -> Span | None:
    return _current.get()


def span(name: str, *, kind: str = "local", **tags) -> _SpanScope:
    """Child scope of the active span; no-op scope when none is active."""
    parent = _current.get()
    if parent is None:
        return _SpanScope(None)
    sp = Span(trace_id=parent.trace_id, span_id=_new_id(),  # t3fslint: allow(span-not-closed) — scope finishes it
              parent_id=parent.span_id, name=name, kind=kind)
    sp.tags.update(tags)
    return _SpanScope(sp)


def start_root(name: str, *, force: bool | None = None, **tags) -> _SpanScope:
    """Root scope: makes the head-sampling decision (cfg.sample_rate), or
    joins the active trace when one exists (nested roots don't fork).
    `force` overrides sampling (tests / CLI-issued traced requests)."""
    if _current.get() is not None:
        return span(name, **tags)
    if force is None:
        rate = _cfg.sample_rate
        if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
            return _SpanScope(None)
    elif not force:
        return _SpanScope(None)
    sp = Span(trace_id=_new_id(), span_id=_new_id(),  # t3fslint: allow(span-not-closed) — scope finishes it
              parent_id=0, name=name, kind="client")
    sp.tags.update(tags)
    return _SpanScope(sp)


def server_scope(name: str, trace_id: int, parent_span_id: int,
                 **tags) -> _SpanScope:
    """Scope for an inbound sampled request: same trace, remote parent.
    The server span is this process's local root — its finish() runs the
    tail-sampling promotion for everything recorded under it here."""
    if not trace_id:
        return _SpanScope(None)
    sp = Span(trace_id=trace_id, span_id=_new_id(),  # t3fslint: allow(span-not-closed) — scope finishes it
              parent_id=parent_span_id, name=name, kind="server",
              remote_parent=True)
    sp.tags.update(tags)
    return _SpanScope(sp)


def start_span(name: str, **tags) -> Span | _NullSpan:
    """Manual child span for flows where a with-block can't bracket the
    work (e.g. a leg finished from a callback).  The caller MUST call
    .finish() — t3fslint span-not-closed enforces this.  The span is NOT
    installed in the contextvar (events attach to it explicitly)."""
    parent = _current.get()
    if parent is None:
        return NULL_SPAN
    sp = Span(trace_id=parent.trace_id, span_id=_new_id(),  # t3fslint: allow(span-not-closed) — manual API, caller finishes
              parent_id=parent.span_id, name=name)
    sp.tags.update(tags)
    return sp


# ----------------------------------------------------- buffer + sampling

@dataclass
class _TraceState:
    spans: list[dict] = field(default_factory=list)
    errored: bool = False
    promoted: bool = False
    deadline: float = 0.0


class SpanBuffer:
    """Bounded per-process span store with tail-based promotion.

    Finished spans buffer per-trace until the trace's local root closes;
    then the trace either promotes to the export deque (slow / errored /
    export=all) or idles until its TTL evicts it.  Late spans of a
    promoted trace (an overlap-pipeline forward outliving the handler)
    export directly.  All bounds come from TraceConfig; overflow drops
    oldest and counts in .dropped."""

    def __init__(self):
        self._lock = threading.Lock()
        self._traces: dict[int, _TraceState] = {}
        self._export: deque[dict] = deque()
        self._buffered = 0
        self._op = 0
        self.finished = 0
        self.promoted = 0
        self.dropped = 0

    def on_finish(self, span: Span) -> None:
        row = span.to_dict()
        now = time.monotonic()
        with self._lock:
            self.finished += 1
            st = self._traces.get(span.trace_id)
            if st is None:
                st = _TraceState(deadline=now + _cfg.trace_ttl_s)
                self._traces[span.trace_id] = st
            if span.status != 0:
                st.errored = True
            if st.promoted:
                self._push_export(row)
            else:
                st.spans.append(row)
                self._buffered += 1
                if len(st.spans) > _cfg.max_trace_spans:
                    st.spans.pop(0)
                    self._buffered -= 1
                    self.dropped += 1
            if span.is_local_root and not st.promoted:
                if (_cfg.export == "all" or st.errored
                        or span.dur_s >= _slow_s(span.name)):
                    st.promoted = True
                    self.promoted += 1
                    for r in st.spans:
                        self._push_export(r)
                    self._buffered -= len(st.spans)
                    st.spans.clear()
            self._op += 1
            if self._op % 64 == 0 or self._buffered > _cfg.max_spans:
                self._prune(now)

    def _push_export(self, row: dict) -> None:
        while len(self._export) >= _cfg.export_max:
            self._export.popleft()
            self.dropped += 1
        self._export.append(row)

    def _prune(self, now: float) -> None:
        expired = [tid for tid, st in self._traces.items()
                   if st.deadline <= now]
        for tid in expired:
            st = self._traces.pop(tid)
            self._buffered -= len(st.spans)
            self.dropped += len(st.spans)
        if self._buffered > _cfg.max_spans:
            # still over cap: evict undecided traces oldest-first
            for tid, st in sorted(self._traces.items(),
                                  key=lambda kv: kv[1].deadline):
                if self._buffered <= _cfg.max_spans:
                    break
                if st.promoted:
                    continue
                self._buffered -= len(st.spans)
                self.dropped += len(st.spans)
                del self._traces[tid]

    def drain(self, max_n: int = 500) -> list[dict]:
        """Pop up to max_n promoted spans for export (MonitorReporter)."""
        out: list[dict] = []
        with self._lock:
            while self._export and len(out) < max_n:
                out.append(self._export.popleft())
        return out

    def pending_export(self) -> int:
        with self._lock:
            return len(self._export)

    def stats(self) -> dict:
        with self._lock:
            return {"finished": self.finished, "promoted": self.promoted,
                    "dropped": self.dropped, "buffered": self._buffered,
                    "export_queued": len(self._export)}

    def reset(self) -> None:
        """Test hook."""
        with self._lock:
            self._traces.clear()
            self._export.clear()
            self._buffered = 0
            self._op = 0
            self.finished = self.promoted = self.dropped = 0


BUFFER = SpanBuffer()


def reset_tracing() -> None:
    """Test hook: default config + empty buffer."""
    configure(TraceConfig())
    BUFFER.reset()


# ------------------------------------------------- legacy flat trace API

@dataclass
class Points:
    """One request's trace: (monotonic ts, event, detail) triples."""
    events: list[tuple[float, str, str]] = field(default_factory=list)
    t0: float = field(default_factory=time.perf_counter)

    def add(self, event: str, detail: str = "") -> None:
        self.events.append((time.perf_counter() - self.t0, event, detail))

    def spans(self) -> list[tuple[str, float]]:
        """(event, seconds-since-previous-event) decomposition."""
        out, prev = [], 0.0
        for ts, event, _ in self.events:
            out.append((event, ts - prev))
            prev = ts
        return out


def start_trace() -> Points:
    """Begin a request scope; returns the live point buffer.  The token
    is kept so end_trace restores the OUTER scope instead of clobbering
    it with None (nested scopes keep their enclosing trace)."""
    p = Points()
    p._token = _points.set(p)
    return p


def current_trace() -> Points | None:
    return _points.get()


def add_event(event: str, detail: str = "") -> None:
    """TRACING_ADD_EVENT analog — attaches to the active span AND the
    legacy point buffer; no-op when neither scope is active."""
    p = _points.get()
    if p is not None:
        p.add(event, detail)
    sp = _current.get()
    if sp is not None:
        sp.add_event(event, detail)


def end_trace() -> Points | None:
    p = _points.get()
    if p is None:
        return None
    token = getattr(p, "_token", None)
    if token is not None:
        _points.reset(token)
    else:
        _points.set(None)
    return p
