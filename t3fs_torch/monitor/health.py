"""Cluster health scorecards and SLO reports over rollup digests.

Pure math over `rollups` rows (the monitor's rollup digests): the monitor
serves these via Monitor.health / Monitor.slo_report, mgmtd caches the
scorecard and piggybacks it on GetRoutingInfoRsp, and MgmtdClient seeds
ReadStats priors from it so a cold client avoids known-slow nodes on its
first read.

Straggler detection is a per-node state machine over consecutive
buckets: a node whose read p99 exceeds K× the per-bucket cluster median
for `m_trigger` consecutive comparable buckets (>= 2 nodes reporting in
the bucket) is flagged, and stays flagged until `m_clear` consecutive
buckets back under the bar — hysteresis so a node bouncing around the
threshold doesn't flap the routing hint.  Freshness is explicit: a node
whose newest bucket is older than `freshness_s` is "stale" and a node
with no rollup rows at all is "unknown"; consumers treat both as
no-prior rather than healthy.

The port of t3fs/monitor/health.py: mgmtd imports it for ClusterHealth;
the monitor service that serves it is not ported.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from t3fs_torch.net.rpcstats import ReadStats
from t3fs_torch.utils.config import ConfigBase, citem
from t3fs_torch.utils.serde import serde_struct

# span-sourced rollup methods that describe the read path (must mirror
# ReadStats.read_methods — the prior is seeded into the same estimator)
READ_METHODS = tuple(sorted(ReadStats.read_methods))

STATE_OK = "ok"
STATE_STRAGGLER = "straggler"
STATE_STALE = "stale"
STATE_UNKNOWN = "unknown"


@dataclass
class HealthConfig(ConfigBase):
    window_s: float = citem(30.0, validator=lambda v: v > 0)
    # straggler bar: p99 > k * cluster-median-p99 for m_trigger
    # consecutive comparable buckets; clears after m_clear under it
    k: float = citem(3.0, validator=lambda v: v > 1)
    m_trigger: int = citem(3, validator=lambda v: v >= 1)
    m_clear: int = citem(3, validator=lambda v: v >= 1)
    freshness_s: float = citem(5.0, validator=lambda v: v > 0)
    avail_target: float = citem(0.999, validator=lambda v: 0 < v <= 1)


@serde_struct
@dataclass
class NodeHealth:
    addr: str = ""
    node_id: int = 0
    state: str = STATE_UNKNOWN
    read_p50_s: float = 0.0
    read_p99_s: float = 0.0
    err_rate: float = 0.0
    count: int = 0
    straggler: bool = False
    stale: bool = False
    trend: int = 0                  # -1 improving, 0 flat, +1 degrading
    updated_ts: float = 0.0         # end of newest contributing bucket
    worst_trace_id: int = 0         # slowest read span for trace-show
    worst_dur_s: float = 0.0
    cls_p9x_ms: dict = field(default_factory=dict)   # size class -> ms


@serde_struct
@dataclass
class ClusterHealth:
    generated_ts: float = 0.0
    window_s: float = 0.0
    bucket_s: float = 0.0
    freshness_s: float = 0.0
    cluster_read_p99_s: float = 0.0
    nodes: list[NodeHealth] = field(default_factory=list)

    def by_addr(self) -> dict:
        return {n.addr: n for n in self.nodes}


@serde_struct
@dataclass
class SloMethod:
    method: str = ""
    count: int = 0
    errors: int = 0
    availability: float = 1.0
    p50_s: float = 0.0
    p99_s: float = 0.0
    avail_target: float = 0.0
    p99_target_s: float = 0.0
    ok: bool = True


@serde_struct
@dataclass
class SloReport:
    window_s: float = 0.0
    generated_ts: float = 0.0
    methods: list[SloMethod] = field(default_factory=list)
    ok: bool = True


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def compute_scorecard(rows: list[dict], now: float, *,
                      window_s: float = 30.0, bucket_s: float = 1.0,
                      k: float = 3.0, m_trigger: int = 3, m_clear: int = 3,
                      freshness_s: float = 5.0,
                      known_addrs: tuple = (),
                      read_methods: tuple = READ_METHODS) -> ClusterHealth:
    """Fold span-sourced rollup rows into a per-node scorecard.

    `rows` are query_rollups() dicts for [now - window_s, now); only
    addr != "" rows whose method is a read-path method contribute.
    `known_addrs` lists nodes that should appear even with no data
    (reported as "unknown" — the routing table knows them, the health
    plane doesn't yet)."""
    # per-addr, per-bucket fold (a node may report several read methods)
    per_addr: dict[str, dict[float, dict]] = {}
    node_ids: dict[str, int] = {}
    for r in rows:
        addr = r.get("addr", "")
        if not addr or r.get("method") not in read_methods:
            continue
        b = per_addr.setdefault(addr, {}).setdefault(
            r["bucket_ts"],
            {"count": 0, "errors": 0, "p50w": 0.0, "p99": 0.0,
             "worst": 0.0, "worst_tid": 0, "cls": {}})
        cnt = int(r.get("count", 0))
        b["count"] += cnt
        b["errors"] += int(r.get("errors", 0))
        b["p50w"] += float(r.get("p50_s", 0.0)) * cnt
        b["p99"] = max(b["p99"], float(r.get("p99_s", 0.0)))
        if float(r.get("worst_dur_s", 0.0)) > b["worst"]:
            b["worst"] = float(r["worst_dur_s"])
            b["worst_tid"] = int(r.get("worst_trace_id", 0))
        if r.get("payload"):
            for cls, d in (json.loads(r["payload"]).get("cls") or {}).items():
                cur = b["cls"].setdefault(cls, [0, 0.0])
                cur[0] += int(d.get("count", 0))
                cur[1] = max(cur[1], float(d.get("p9x_s", 0.0)))
        if r.get("node_id"):
            node_ids[addr] = int(r["node_id"])

    # bucket grid over the window, oldest -> newest
    all_buckets = sorted({b for per in per_addr.values() for b in per})
    # per-bucket cluster median p99 (comparable only when >= 2 nodes
    # reported in that bucket — one node has no peers to be slower than)
    medians: dict[float, float] = {}
    for b in all_buckets:
        p99s = [per[b]["p99"] for per in per_addr.values() if b in per]
        if len(p99s) >= 2:
            medians[b] = _median(p99s)

    nodes = []
    for addr in sorted(set(per_addr) | set(known_addrs)):
        per = per_addr.get(addr)
        nh = NodeHealth(addr=addr, node_id=node_ids.get(addr, 0))
        if not per:
            nodes.append(nh)    # unknown: routing knows it, health doesn't
            continue
        # straggler state machine over the bucket sequence
        over = under = 0
        straggler = False
        for b in all_buckets:
            med = medians.get(b)
            if med is None or med <= 0 or b not in per:
                continue
            if per[b]["p99"] > k * med:
                over += 1
                under = 0
                if over >= m_trigger:
                    straggler = True
            else:
                under += 1
                over = 0
                if under >= m_clear:
                    straggler = False
        # headline stats: newest 3 non-empty buckets (recent but not
        # single-bucket noisy); trend compares window halves
        mine = sorted(per)
        recent = mine[-3:]
        cnt = sum(per[b]["count"] for b in recent)
        nh.count = sum(per[b]["count"] for b in mine)
        nh.err_rate = (sum(per[b]["errors"] for b in mine) / nh.count
                       if nh.count else 0.0)
        nh.read_p50_s = (sum(per[b]["p50w"] for b in recent) / cnt
                         if cnt else 0.0)
        nh.read_p99_s = max((per[b]["p99"] for b in recent), default=0.0)
        half = len(mine) // 2
        if half:
            old = _median([per[b]["p99"] for b in mine[:half]])
            new = _median([per[b]["p99"] for b in mine[half:]])
            if old > 0:
                ratio = new / old
                nh.trend = 1 if ratio > 1.25 else (-1 if ratio < 0.8 else 0)
        worst = max(mine, key=lambda b: per[b]["worst"])
        nh.worst_dur_s = per[worst]["worst"]
        nh.worst_trace_id = per[worst]["worst_tid"]
        cls_acc: dict[str, list] = {}
        for b in mine:
            for cls, (c, p) in per[b]["cls"].items():
                cur = cls_acc.setdefault(cls, [0, 0.0])
                cur[0] += c
                cur[1] = max(cur[1], p)
        nh.cls_p9x_ms = {cls: round(p * 1e3, 3)
                         for cls, (c, p) in cls_acc.items() if c >= 4}
        nh.updated_ts = mine[-1] + bucket_s
        nh.straggler = straggler
        nh.stale = now - nh.updated_ts > freshness_s
        nh.state = (STATE_STALE if nh.stale
                    else STATE_STRAGGLER if straggler else STATE_OK)
        nodes.append(nh)

    cluster_p99 = _median([n.read_p99_s for n in nodes if n.count])
    return ClusterHealth(
        generated_ts=now, window_s=window_s, bucket_s=bucket_s,
        freshness_s=freshness_s, cluster_read_p99_s=cluster_p99,
        nodes=nodes)


def compute_slo(rows: list[dict], now: float, *, window_s: float = 30.0,
                avail_target: float = 0.999,
                p99_targets: dict | None = None) -> SloReport:
    """Per-method availability + latency objectives over the window.

    Prefers stats-sourced rows (addr == "", unbiased serving-side
    RpcStats) per method; falls back to span-sourced rows only for
    methods with no stats coverage (tail-sampled spans over-represent
    slow traces, so the fallback is conservative)."""
    p99_targets = p99_targets or {}
    per: dict[str, dict] = {}
    for r in rows:
        method = r.get("method", "")
        if not method:
            continue
        src = "stats" if not r.get("addr") else "spans"
        m = per.setdefault(method, {"stats": None, "spans": None})
        a = m[src]
        if a is None:
            a = m[src] = {"count": 0, "errors": 0, "p50w": 0.0, "p99": 0.0}
        cnt = int(r.get("count", 0))
        a["count"] += cnt
        a["errors"] += int(r.get("errors", 0))
        a["p50w"] += float(r.get("p50_s", 0.0)) * cnt
        a["p99"] = max(a["p99"], float(r.get("p99_s", 0.0)))
    methods = []
    all_ok = True
    for method in sorted(per):
        a = per[method]["stats"] or per[method]["spans"]
        if not a or not a["count"]:
            continue
        avail = 1.0 - a["errors"] / a["count"]
        tgt = float(p99_targets.get(method, 0.0))
        p99 = a["p99"]
        ok = avail >= avail_target and (tgt <= 0 or p99 <= tgt)
        all_ok = all_ok and ok
        methods.append(SloMethod(
            method=method, count=a["count"], errors=a["errors"],
            availability=avail, p50_s=a["p50w"] / a["count"], p99_s=p99,
            avail_target=avail_target, p99_target_s=tgt, ok=ok))
    return SloReport(window_s=window_s, generated_ts=now,
                     methods=methods, ok=all_ok)


def scorecard_from_db(db, now: float | None = None,
                      cfg: HealthConfig | None = None,
                      bucket_s: float = 1.0,
                      known_addrs: tuple = ()) -> ClusterHealth:
    cfg = cfg or HealthConfig()
    now = time.time() if now is None else now
    rows = db.query_rollups(ts_min=now - cfg.window_s, ts_max=now)
    return compute_scorecard(
        rows, now, window_s=cfg.window_s, bucket_s=bucket_s, k=cfg.k,
        m_trigger=cfg.m_trigger, m_clear=cfg.m_clear,
        freshness_s=cfg.freshness_s, known_addrs=known_addrs)


def slo_from_db(db, now: float | None = None,
                cfg: HealthConfig | None = None,
                p99_targets: dict | None = None) -> SloReport:
    cfg = cfg or HealthConfig()
    now = time.time() if now is None else now
    rows = db.query_rollups(ts_min=now - cfg.window_s, ts_max=now)
    return compute_slo(rows, now, window_s=cfg.window_s,
                       avail_target=cfg.avail_target,
                       p99_targets=p99_targets)
