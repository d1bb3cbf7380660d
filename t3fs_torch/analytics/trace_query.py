"""Trace query: the READER half of analytics.

Reference analog: src/analytics/SerdeObjectReader.h:2-4 pairs the Parquet
writer with a reader so the structured traces can be CONSUMED, not just
produced.  This module aggregates StorageEventTrace files into the
latency/error breakdowns an operator actually asks for ("which hop is
slow", "which target errors"), surfaced in the reference as
`t3fs-admin trace-read` / `trace-top`.

The port of t3fs/analytics/trace_query.py, a copy with its imports
re-pointed; t3fs_torch/cli/admin.py's `trace-read` and `trace-top` read
through it.
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass, field

from t3fs_torch.analytics.trace_log import read_trace


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


@dataclass
class TraceGroupStats:
    key: str = ""
    count: int = 0
    errors: int = 0
    bytes: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    max_ms: float = 0.0
    mean_ms: float = 0.0
    _lat: list[float] = field(default_factory=list, repr=False)

    def add(self, row: dict) -> None:
        self.count += 1
        self.bytes += row.get("length", 0)
        if row.get("commit_status", 0) != 0:
            self.errors += 1
        self._lat.append(row.get("latency_s", 0.0))

    def finish(self) -> "TraceGroupStats":
        lat = sorted(self._lat)
        self.p50_ms = round(_percentile(lat, 0.50) * 1e3, 3)
        self.p99_ms = round(_percentile(lat, 0.99) * 1e3, 3)
        self.max_ms = round((lat[-1] if lat else 0.0) * 1e3, 3)
        self.mean_ms = round((sum(lat) / len(lat) if lat else 0.0) * 1e3, 3)
        return self


GROUP_KEYS = {
    "node": lambda r: f"node {r.get('node_id')}",
    "target": lambda r: f"target {r.get('target_id')}",
    "chain": lambda r: f"chain {r.get('chain_id')}",
    "type": lambda r: r.get("update_type", "?"),
    "status": lambda r: f"status {r.get('commit_status')}",
}


def expand_paths(paths: list[str]) -> list[str]:
    """Accept files, directories (all *.parquet inside), and globs."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(_glob.glob(os.path.join(p, "*.parquet"))))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    return out


REQUIRED_FIELDS = {"node_id", "target_id", "chain_id", "latency_s",
                   "commit_status"}


def _is_storage_trace(path: str) -> bool:
    """Schema gate: a cluster data dir also holds OTHER parquet logs
    (meta_events.parquet) whose rows lack the storage-trace fields —
    gluing them into the aggregation would crash or pollute stats."""
    import pyarrow.parquet as pq
    try:
        names = set(pq.read_schema(path).names)
    except Exception:
        return False
    return REQUIRED_FIELDS <= names


def iter_rows(paths: list[str], *, chain: int = 0, node: int = 0,
              errors_only: bool = False):
    for path in expand_paths(paths):
        if not _is_storage_trace(path):
            continue
        for row in read_trace(path):
            if chain and row.get("chain_id") != chain:
                continue
            if node and row.get("node_id") != node:
                continue
            if errors_only and row.get("commit_status", 0) == 0:
                continue
            yield row


def top(paths: list[str], by: str = "target", **filters
        ) -> list[TraceGroupStats]:
    """Aggregate rows into per-group latency/error stats, slowest-p99
    first — the 'which hop hurts' view."""
    keyfn = GROUP_KEYS[by]
    groups: dict[str, TraceGroupStats] = {}
    for row in iter_rows(paths, **filters):
        k = keyfn(row)
        g = groups.get(k)
        if g is None:
            g = groups[k] = TraceGroupStats(key=k)
        g.add(row)
    return sorted((g.finish() for g in groups.values()),
                  key=lambda g: -g.p99_ms)
