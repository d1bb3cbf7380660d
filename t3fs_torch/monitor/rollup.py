"""Continuous span/metric rollups: the health plane's aggregation pass.

The monitor's raw `spans` and `metrics` tables are write-optimized and
short-retention; nothing in the repo consumed them continuously — the
trace CLI scans on demand and per-process ReadStats start cold.  This
pass folds both tables into time-bucketed per-(node, method) digests in
the `rollups` table, incrementally: each tick scans only the half-open
arrival-time window [high-water-mark, now - lag) per source table, so a
long-running monitor never rescans history.

Two row sources, disambiguated by the `addr` column:

- addr != "": span-sourced rows, keyed by the server span's `addr` tag
  (the serving node's listen address — the only per-node key that
  survives in-process clusters where every node shares one process-wide
  stats registry).  Carry exact p50/p99 over the bucket's span
  durations, the wire/queue/apply/forward hop decomposition from span
  tags, the worst (dur, trace_id) for drill-down, and per-size-class
  tails from the `bytes` tag.  Under tail sampling these are biased
  toward slow traces — fine for straggler detection, wrong for SLOs.
- addr == "": stats-sourced rows from `rpc.latency` samples'
  `server_methods` (serving-side RpcStats window) — unbiased
  count/error/latency totals, used by the SLO report.

The port of t3fs/monitor/rollup.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass

from t3fs_torch.utils.config import ConfigBase, citem

# span tags folded into hop columns (set by conn._handle_request and the
# storage apply/forward paths)
_HOP_TAGS = ("wire_s", "queue_s", "apply_s", "forward_s")


@dataclass
class RollupConfig(ConfigBase):
    bucket_s: float = citem(1.0, validator=lambda v: v > 0)
    period_s: float = citem(1.0, validator=lambda v: v > 0)
    # scan up to now - lag_s so in-flight reporter pushes for the current
    # tick land before their window closes
    lag_s: float = citem(0.25, validator=lambda v: v >= 0)
    max_rows_per_pass: int = citem(50000, validator=lambda v: v > 0)


def _pctl(sorted_vals: list[float], q: float) -> float:
    """Exact nearest-rank percentile of an ascending list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class _Acc:
    __slots__ = ("durs", "cls_durs", "errors", "wire_s", "queue_s",
                 "apply_s", "forward_s", "worst_dur_s", "worst_trace_id")

    def __init__(self):
        self.durs = []
        self.cls_durs: dict[int, list] = {}
        self.errors = 0
        self.wire_s = self.queue_s = self.apply_s = self.forward_s = 0.0
        self.worst_dur_s = 0.0
        self.worst_trace_id = 0


class RollupEngine:
    """Incremental aggregator over a MetricsDB; one instance per monitor."""

    def __init__(self, db, cfg: RollupConfig | None = None):
        self.db = db
        self.cfg = cfg or RollupConfig()
        # arrival-ts high-water marks, one per source table
        self._hwm_spans = 0.0
        self._hwm_metrics = 0.0
        self.passes = 0
        self.rows_written = 0

    def rollup_once(self, now: float | None = None) -> int:
        """Fold new arrivals into rollup rows; returns rows written."""
        now = time.time() if now is None else now
        cut = now - self.cfg.lag_s
        rows = self._rollup_spans(cut) + self._rollup_stats(cut)
        if rows:
            self.rows_written += self.db.insert_rollups(rows)
        self.passes += 1
        return len(rows)

    # -- span-sourced digests (addr != "") --------------------------------

    def _rollup_spans(self, cut: float) -> list[dict]:
        if cut <= self._hwm_spans:
            return []
        cap = self.cfg.max_rows_per_pass
        spans = self.db.query_spans(
            ts_min=self._hwm_spans, ts_max=cut, order="ts", limit=cap)
        if len(spans) >= cap:
            # window overflowed the scan cap.  ts_min is INCLUSIVE, so
            # the next pass re-reads whatever arrival-ts group the cap
            # split — fold only rows BEFORE that group now (once), and
            # park the high-water mark on it.
            last = max(s.get("ts", 0.0) for s in spans)
            head = [s for s in spans if s.get("ts", 0.0) < last]
            if head:
                spans, next_hwm = head, last
            else:
                # every scanned row shares one arrival ts (one reporter
                # batch larger than the cap): fetch that whole group so
                # it folds exactly once, then step past it
                group = self.db.query_spans(
                    ts_min=last, ts_max=cut, order="ts", limit=10 * cap)
                spans = [s for s in group if s.get("ts", 0.0) <= last]
                next_hwm = math.nextafter(last, math.inf)
        else:
            next_hwm = cut
        buckets: dict[tuple, _Acc] = {}
        for s in spans:
            if s.get("kind") != "server":
                continue
            tags = s.get("tags") or {}
            addr = str(tags.get("addr", ""))
            if not addr:
                continue
            bucket = (s["ts"] // self.cfg.bucket_s) * self.cfg.bucket_s
            key = (bucket, int(s.get("node_id", 0)), addr,
                   s.get("name", ""))
            acc = buckets.get(key)
            if acc is None:
                acc = buckets[key] = _Acc()
            dur = float(s.get("dur_s", 0.0))
            acc.durs.append(dur)
            if s.get("status"):
                acc.errors += 1
            for hop in _HOP_TAGS:
                v = tags.get(hop)
                if v is not None:
                    setattr(acc, hop, getattr(acc, hop) + float(v))
            if dur > acc.worst_dur_s:
                acc.worst_dur_s = dur
                acc.worst_trace_id = int(s.get("trace_id", 0))
            nbytes = tags.get("bytes")
            if nbytes is not None:
                from t3fs_torch.net.rpcstats import read_size_class
                acc.cls_durs.setdefault(
                    read_size_class(int(nbytes)), []).append(dur)
        self._hwm_spans = next_hwm
        return [self._span_row(k, a) for k, a in sorted(buckets.items())]

    def _span_row(self, key: tuple, acc: _Acc) -> dict:
        bucket, node_id, addr, method = key
        durs = sorted(acc.durs)
        payload = {}
        if acc.cls_durs:
            payload["cls"] = {
                str(cls): {"count": len(d),
                           "p9x_s": _pctl(sorted(d), 0.95)}
                for cls, d in acc.cls_durs.items()}
        return {
            "bucket_ts": bucket, "bucket_s": self.cfg.bucket_s,
            "node_id": node_id, "addr": addr, "method": method,
            "count": len(durs), "errors": acc.errors,
            "p50_s": _pctl(durs, 0.5), "p99_s": _pctl(durs, 0.99),
            "wire_s": acc.wire_s, "queue_s": acc.queue_s,
            "apply_s": acc.apply_s, "forward_s": acc.forward_s,
            "worst_dur_s": acc.worst_dur_s,
            "worst_trace_id": acc.worst_trace_id,
            "payload": json.dumps(payload) if payload else "",
        }

    # -- stats-sourced digests (addr == "") -------------------------------

    def _rollup_stats(self, cut: float) -> list[dict]:
        if cut <= self._hwm_metrics:
            return []
        samples = self.db.query(
            name_prefix="rpc.latency", since_ts=self._hwm_metrics,
            ts_max=cut, limit=self.cfg.max_rows_per_pass)
        self._hwm_metrics = cut
        # (bucket, node_id, method) -> [count, errors, p50*count, p99max]
        agg: dict[tuple, list] = {}
        for smp in samples:
            methods = smp.get("server_methods") or {}
            bucket = (smp["ts"] // self.cfg.bucket_s) * self.cfg.bucket_s
            for method, row in methods.items():
                key = (bucket, int(smp.get("node_id", 0)), method)
                a = agg.setdefault(key, [0, 0, 0.0, 0.0])
                cnt = int(row.get("count", 0))
                a[0] += cnt
                a[1] += int(row.get("errors", 0))
                a[2] += float(row.get("total_p50_ms", 0.0)) / 1e3 * cnt
                a[3] = max(a[3], float(row.get("total_p99_ms", 0.0)) / 1e3)
        out = []
        for (bucket, node_id, method), (cnt, errs, p50w, p99) in \
                sorted(agg.items()):
            if not cnt:
                continue
            out.append({
                "bucket_ts": bucket, "bucket_s": self.cfg.bucket_s,
                "node_id": node_id, "addr": "", "method": method,
                "count": cnt, "errors": errs,
                "p50_s": p50w / cnt, "p99_s": p99,
                "wire_s": 0.0, "queue_s": 0.0, "apply_s": 0.0,
                "forward_s": 0.0, "worst_dur_s": 0.0, "worst_trace_id": 0,
                "payload": "",
            })
        return out
