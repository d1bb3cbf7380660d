"""Harvest + grading: turn raw driver op logs into a graded report.

Three layers:

- per-workload stats — p50/p99 latency, achieved ops/s, goodput share
  (`min(1, achieved/demand)`: demand *satisfaction*, so a checkpoint
  cycle and a 64 KiB read grade on the same axis);
- cross-workload — Jain's fairness index over the shares, the
  zero-wrong-bytes total, the per-window progress (starvation) check;
- SLO gates — each gate is (ok, detail); the runner decides which are
  fatal in which cell (fairness is a faults-off gate by design: a crash
  SHOULD dent the victim's share).

Trace capture: the tail sampler promotes slow/errored traces into
the process-global span buffer during the run; `capture_worst_trace`
drains that buffer into an in-memory MetricsDB, picks the slowest root,
and renders its cross-node critical path with the same `render_trace`
the `admin trace-show` command uses — so the worst p99 spike in the
report ships with its explanation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from t3fs_torch.soak.spec import SoakSpec
from t3fs_torch.utils import tracing


def jain_fairness(shares: list[float]) -> float:
    """Jain's index (Σx)² / (n·Σx²) ∈ [1/n, 1].  All-zero shares return
    0.0, not the all-equal limit of 1.0 — a fabric where every workload
    got nothing must not pass a fairness gate."""
    if not shares:
        return 1.0
    x = np.asarray(shares, dtype=float)
    sq = float(np.sum(x * x))
    if sq == 0.0:
        return 0.0
    return float(np.sum(x)) ** 2 / (len(x) * sq)


def _pct_ms(lats_s: list[float], p: float) -> float:
    if not lats_s:
        return 0.0
    return float(np.percentile(np.asarray(lats_s), p)) * 1000.0


@dataclass
class WorkloadResult:
    name: str
    kind: str
    mode: str
    demand_ops_s: float
    ops_ok: int = 0
    ops_err: int = 0
    shed: int = 0
    cancelled: int = 0
    wrong_bytes: int = 0
    bytes_moved: int = 0
    achieved_ops_s: float = 0.0
    share: float = 0.0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    window_ops: list[int] = field(default_factory=list)

    @property
    def starved(self) -> bool:
        return bool(self.window_ops) and min(self.window_ops) == 0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "mode": self.mode,
            "ops_ok": self.ops_ok, "ops_err": self.ops_err,
            "shed": self.shed, "cancelled": self.cancelled,
            "wrong_bytes": self.wrong_bytes,
            "mb_moved": round(self.bytes_moved / 1e6, 3),
            "ops_s": round(self.achieved_ops_s, 3),
            "share": round(self.share, 4),
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "window_ops": self.window_ops,
        }


@dataclass
class SoakReport:
    name: str
    elapsed_s: float
    workloads: list[WorkloadResult]
    fairness: float
    wrong_bytes: int
    fault_events: list = field(default_factory=list)
    gates: dict = field(default_factory=dict)   # name -> (ok, detail)
    worst_trace_root: dict | None = None
    worst_trace_rendered: str = ""

    @property
    def passed(self) -> bool:
        return all(ok for ok, _ in self.gates.values())

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "elapsed_s": round(self.elapsed_s, 2),
            "fairness": round(self.fairness, 4),
            "wrong_bytes": self.wrong_bytes,
            "workloads": {w.name: w.to_dict() for w in self.workloads},
            "faults": [{"t": round(e.t, 2), "kind": e.kind,
                        "node": e.node, "ok": e.ok, "detail": e.detail}
                       for e in self.fault_events],
            "gates": {k: {"ok": ok, "detail": d}
                      for k, (ok, d) in self.gates.items()},
            "passed": self.passed,
            "worst_trace": (self.worst_trace_root or {}).get("name", ""),
            "worst_trace_ms": round((self.worst_trace_root or {})
                                    .get("dur_s", 0.0) * 1000, 3),
        }


def summarize(spec: SoakSpec, drivers, elapsed_s: float) -> SoakReport:
    """Shape raw driver state into a report (gates added by `grade`)."""
    nwin = spec.slo.progress_windows
    win = max(1e-9, elapsed_s / nwin)
    results = []
    for d in drivers:
        ok_ops = [o for o in d.ops if o.ok]
        lats = [o.lat_s for o in ok_ops]
        windows = [0] * nwin
        for o in ok_ops:
            windows[min(nwin - 1, int(o.t / win))] += 1
        achieved = len(ok_ops) / max(1e-9, elapsed_s)
        results.append(WorkloadResult(
            name=d.name, kind=d.wl.kind, mode=d.wl.mode,
            demand_ops_s=d.wl.demand_ops_s,
            ops_ok=len(ok_ops), ops_err=d.errors, shed=d.shed,
            cancelled=d.cancelled, wrong_bytes=d.wrong_bytes,
            bytes_moved=sum(o.nbytes for o in ok_ops),
            achieved_ops_s=achieved,
            share=min(1.0, achieved / d.wl.demand_ops_s),
            p50_ms=_pct_ms(lats, 50), p99_ms=_pct_ms(lats, 99),
            window_ops=windows))
    return SoakReport(
        name=spec.name, elapsed_s=elapsed_s, workloads=results,
        fairness=jain_fairness([w.share for w in results]),
        wrong_bytes=sum(w.wrong_bytes for w in results))


def grade(report: SoakReport, spec: SoakSpec,
          require_fairness: bool = True) -> SoakReport:
    """Attach SLO gates.  `require_fairness=False` for a faults-on cell:
    a crash SHOULD dent the victim's share, so fairness reports but does
    not gate there.  Progress and zero-wrong-bytes gate in EVERY cell —
    degraded is acceptable, starved or corrupt never is."""
    slo = spec.slo
    g: dict[str, tuple[bool, str]] = {}
    g["zero_wrong_bytes"] = (
        report.wrong_bytes == 0, f"{report.wrong_bytes} wrong bytes")
    starved = [w.name for w in report.workloads
               if min(w.window_ops or [0]) < slo.min_ops_per_window]
    g["progress"] = (
        not starved,
        "all workloads progressed in every window" if not starved
        else f"starved: {starved}")
    if require_fairness:
        g["fairness"] = (
            report.fairness >= slo.min_fairness,
            f"jain={report.fairness:.3f} vs min {slo.min_fairness}")
    if slo.max_p99_ms > 0:
        slow = {w.name: round(w.p99_ms, 1) for w in report.workloads
                if w.p99_ms > slo.max_p99_ms}
        g["p99"] = (not slow, f"over {slo.max_p99_ms}ms: {slow}"
                    if slow else f"all p99 <= {slo.max_p99_ms}ms")
    report.gates = g
    return report


def capture_worst_trace(name_prefix: str = "", db=None
                        ) -> tuple[dict | None, str]:
    """Drain the tail-sampled span buffer and render the slowest root's
    full cross-node trace.  Returns (root span dict | None, rendered
    tree).  Call once, after drain — draining consumes the buffer.

    Pass the soak collector's MetricsDB when a MonitorReporter has been
    shipping spans there during the run: the reporter drains
    the process buffer continuously, so harvest time finds only a final
    sliver locally — the full history lives in the collector's table."""
    from t3fs_torch.cli.admin import render_trace
    from t3fs_torch.monitor.service import MetricsDB
    db = db or MetricsDB()
    now = time.time()
    while True:
        spans = tracing.BUFFER.drain(500)
        if not spans:
            break
        db.insert_spans(0, "soak", now, spans)
    roots = db.query_spans(name_prefix=name_prefix, roots_only=True,
                           limit=1)
    if not roots:
        return None, "(no tail-sampled traces captured)"
    worst = roots[0]
    trace = db.query_spans(trace_id=worst["trace_id"], limit=500)
    return worst, render_trace(trace)
