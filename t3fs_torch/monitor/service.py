"""monitor_collector: cluster-wide metric aggregation service.

Reference analog: src/monitor_collector/ — a service that fans metric
samples pushed from every node into ClickHouse (deploy/sql/3fs-monitor.sql),
fed by each node's MonitorCollectorClient reporter
(common/monitor/MonitorCollectorClient).  Here the sink is sqlite (baked into
Python, queryable like the ClickHouse tables) with a JSONL side option, and
a query RPC used by the admin CLI.

The port of t3fs/monitor/service.py, a copy with its imports re-pointed:
the same wire structs, sqlite rows and scorecard.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field, replace

from t3fs_torch.monitor.health import (ClusterHealth, HealthConfig, SloReport,
                                 scorecard_from_db, slo_from_db)
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.utils.serde import serde_struct

_SCHEMA = """
CREATE TABLE IF NOT EXISTS metrics (
  ts REAL NOT NULL,
  node_id INTEGER NOT NULL,
  node_type TEXT NOT NULL,
  name TEXT NOT NULL,
  kind TEXT NOT NULL,
  value REAL,
  payload TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS metrics_name_ts ON metrics (name, ts);
CREATE TABLE IF NOT EXISTS spans (
  ts REAL NOT NULL,
  node_id INTEGER NOT NULL,
  node_type TEXT NOT NULL,
  trace_id INTEGER NOT NULL,
  span_id INTEGER NOT NULL,
  parent_id INTEGER NOT NULL,
  name TEXT NOT NULL,
  kind TEXT NOT NULL,
  t0 REAL NOT NULL,
  dur_s REAL NOT NULL,
  status INTEGER NOT NULL,
  root INTEGER NOT NULL,
  payload TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS spans_trace ON spans (trace_id);
CREATE INDEX IF NOT EXISTS spans_name_dur ON spans (name, dur_s);
CREATE INDEX IF NOT EXISTS spans_ts ON spans (ts);
CREATE TABLE IF NOT EXISTS rollups (
  bucket_ts REAL NOT NULL,
  bucket_s REAL NOT NULL,
  node_id INTEGER NOT NULL,
  addr TEXT NOT NULL,
  method TEXT NOT NULL,
  count INTEGER NOT NULL,
  errors INTEGER NOT NULL,
  p50_s REAL NOT NULL,
  p99_s REAL NOT NULL,
  wire_s REAL NOT NULL,
  queue_s REAL NOT NULL,
  apply_s REAL NOT NULL,
  forward_s REAL NOT NULL,
  worst_dur_s REAL NOT NULL,
  worst_trace_id INTEGER NOT NULL,
  payload TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS rollups_ts ON rollups (bucket_ts);
CREATE INDEX IF NOT EXISTS rollups_key ON rollups (addr, method, bucket_ts);
"""

_ROLLUP_COLS = ("bucket_ts", "bucket_s", "node_id", "addr", "method",
                "count", "errors", "p50_s", "p99_s", "wire_s", "queue_s",
                "apply_s", "forward_s", "worst_dur_s", "worst_trace_id",
                "payload")


class MetricsDB:
    """sqlite sink (the ClickHouse-table analog, deploy/sql/3fs-monitor.sql).

    Retention: max_age_s drops rows older than that; max_rows caps the
    metrics/spans tables, oldest-first (0 = unbounded).  The row cap is
    enforced from an exact in-memory row counter (seeded with ONE
    COUNT(*) per table at open, maintained from insert/DELETE rowcounts)
    so the insert hot path never re-counts the table; age pruning is
    amortized to one DELETE per `prune_every_s` per table.  Rollup rows
    (the health plane's time-bucketed digests, rollup.py)
    have their own age-only retention `rollup_max_age_s`."""

    def __init__(self, path: str = ":memory:", max_age_s: float = 0.0,
                 max_rows: int = 0, rollup_max_age_s: float = 900.0,
                 prune_every_s: float = 2.0):
        self.path = path
        self.max_age_s = max_age_s
        self.max_rows = max_rows
        self.rollup_max_age_s = rollup_max_age_s
        self.prune_every_s = prune_every_s
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self._ts_col = {"metrics": "ts", "spans": "ts",
                        "rollups": "bucket_ts"}
        with self._lock:
            self._conn.executescript(_SCHEMA)
            # exact counters: one COUNT(*) per table at OPEN (an existing
            # on-disk db), never again on the insert path
            self._rows = {t: self._conn.execute(
                f"SELECT COUNT(*) FROM {t}").fetchone()[0]
                for t in self._ts_col}
        self._age_pruned_at = dict.fromkeys(self._ts_col, 0.0)

    def _age_of(self, table: str) -> float:
        return (self.rollup_max_age_s if table == "rollups"
                else self.max_age_s)

    def _prune_locked(self, table: str, force: bool = False) -> None:
        """Apply retention to one table; caller holds the lock.  Row-cap
        pruning runs whenever the counter says the table is over (exact,
        no COUNT(*)); age pruning runs at most once per prune_every_s
        unless forced."""
        ts_col = self._ts_col[table]
        now = time.time()
        age = self._age_of(table)
        if age > 0 and (force or
                        now - self._age_pruned_at[table] >= self.prune_every_s):
            cur = self._conn.execute(
                f"DELETE FROM {table} WHERE {ts_col} < ?", (now - age,))
            self._rows[table] -= cur.rowcount
            self._age_pruned_at[table] = now
        if table != "rollups" and self.max_rows > 0 \
                and self._rows[table] > self.max_rows:
            cur = self._conn.execute(
                f"DELETE FROM {table} WHERE rowid IN ("
                f"SELECT rowid FROM {table} ORDER BY {ts_col} ASC LIMIT ?)",
                (self._rows[table] - self.max_rows,))
            self._rows[table] -= cur.rowcount

    def prune_now(self) -> None:
        """Force retention on every table (tests / shutdown compaction)."""
        with self._lock:
            for table in self._ts_col:
                self._prune_locked(table, force=True)
            self._conn.commit()

    def insert(self, node_id: int, node_type: str, ts: float,
               samples: list[dict]) -> int:
        rows = []
        for s in samples:
            value = s.get("value", s.get("mean"))
            rows.append((ts, node_id, node_type, s.get("name", ""),
                         s.get("type", ""),
                         float(value) if value is not None else None,
                         json.dumps(s, default=str)))
        with self._lock:
            self._conn.executemany(
                "INSERT INTO metrics VALUES (?,?,?,?,?,?,?)", rows)
            self._rows["metrics"] += len(rows)
            self._prune_locked("metrics")
            self._conn.commit()
        return len(rows)

    def insert_spans(self, node_id: int, node_type: str, ts: float,
                     spans: list[dict]) -> int:
        rows = []
        for s in spans:
            rows.append((ts, node_id, node_type,
                         int(s.get("trace_id", 0)), int(s.get("span_id", 0)),
                         int(s.get("parent_id", 0)), s.get("name", ""),
                         s.get("kind", ""), float(s.get("t0", 0.0)),
                         float(s.get("dur_s", 0.0)), int(s.get("status", 0)),
                         1 if s.get("root") else 0,
                         json.dumps(s, default=str)))
        with self._lock:
            self._conn.executemany(
                "INSERT INTO spans VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)", rows)
            self._rows["spans"] += len(rows)
            self._prune_locked("spans")
            self._conn.commit()
        return len(rows)

    def insert_rollups(self, rows: list[dict]) -> int:
        """Store one rollup pass's digests (rollup.py)."""
        vals = [tuple(r.get(c, "" if c in ("addr", "method", "payload")
                            else 0) for c in _ROLLUP_COLS) for r in rows]
        with self._lock:
            self._conn.executemany(
                "INSERT INTO rollups VALUES ("
                + ",".join("?" * len(_ROLLUP_COLS)) + ")", vals)
            self._rows["rollups"] += len(vals)
            self._prune_locked("rollups")
            self._conn.commit()
        return len(vals)

    def query_rollups(self, ts_min: float = 0.0, ts_max: float = 0.0,
                      node_id: int = 0, addr: str = "", method: str = "",
                      limit: int = 100000) -> list[dict]:
        """Time-bucketed digests, ascending bucket_ts.  ts_max is
        EXCLUSIVE (half-open scan windows compose without overlap)."""
        conds, params = ["bucket_ts >= ?"], [ts_min]
        if ts_max > 0:
            conds.append("bucket_ts < ?")
            params.append(ts_max)
        if node_id:
            conds.append("node_id = ?")
            params.append(node_id)
        if addr:
            conds.append("addr = ?")
            params.append(addr)
        if method:
            conds.append("method = ?")
            params.append(method)
        q = ("SELECT " + ", ".join(_ROLLUP_COLS) + " FROM rollups WHERE "
             + " AND ".join(conds) + " ORDER BY bucket_ts ASC LIMIT ?")
        params.append(limit)
        with self._lock:
            rows = self._conn.execute(q, params).fetchall()
        return [dict(zip(_ROLLUP_COLS, r)) for r in rows]

    def query_spans(self, trace_id: int = 0, name_prefix: str = "",
                    min_dur_s: float = 0.0, roots_only: bool = False,
                    limit: int = 1000, ts_min: float = 0.0,
                    ts_max: float = 0.0, node_id: int = 0,
                    order: str = "dur") -> list[dict]:
        """ts_min/ts_max bound the span's ARRIVAL time at the monitor
        (the row ts, not t0): arrival is monotone per reporter, so the
        rollup pass can scan [hwm, cut) windows without re-reading or
        missing late exports.  ts_max is EXCLUSIVE.  order="ts" scans
        ascending by arrival (incremental pass); "dur" keeps the
        slowest-first order the trace CLI wants."""
        conds, params = ["dur_s >= ?"], [min_dur_s]
        if trace_id:
            conds.append("trace_id = ?")
            params.append(trace_id)
        if name_prefix:
            conds.append("name >= ? AND name < ?")
            params += [name_prefix, name_prefix + chr(0x10FFFF)]
        if roots_only:
            conds.append("root = 1")
        if ts_min > 0:
            conds.append("ts >= ?")
            params.append(ts_min)
        if ts_max > 0:
            conds.append("ts < ?")
            params.append(ts_max)
        if node_id:
            conds.append("node_id = ?")
            params.append(node_id)
        order_by = "ts ASC" if order == "ts" else "dur_s DESC"
        q = ("SELECT ts, node_id, node_type, payload FROM spans WHERE "
             + " AND ".join(conds) + f" ORDER BY {order_by} LIMIT ?")
        params.append(limit)
        with self._lock:
            rows = self._conn.execute(q, params).fetchall()
        out = []
        for ts, node_id_, node_type, payload in rows:
            d = json.loads(payload)
            d.update(ts=ts, node_id=node_id_, node_type=node_type)
            out.append(d)
        return out

    def query(self, name_prefix: str = "", since_ts: float = 0.0,
              limit: int = 1000, ts_max: float = 0.0,
              node_id: int = 0) -> list[dict]:
        # range comparison, not LIKE: metric names routinely contain '_',
        # which LIKE would treat as a wildcard.  ts_max is EXCLUSIVE.
        conds = ["ts >= ?", "name >= ?", "name < ?"]
        params: list = [since_ts, name_prefix, name_prefix + chr(0x10FFFF)]
        if ts_max > 0:
            conds.append("ts < ?")
            params.append(ts_max)
        if node_id:
            conds.append("node_id = ?")
            params.append(node_id)
        q = ("SELECT ts, node_id, node_type, payload FROM metrics WHERE "
             + " AND ".join(conds) + " ORDER BY ts DESC LIMIT ?")
        params.append(limit)
        with self._lock:
            cur = self._conn.execute(q, params)
            rows = cur.fetchall()
        out = []
        for ts, node_id_, node_type, payload in rows:
            d = json.loads(payload)
            d.update(ts=ts, node_id=node_id_, node_type=node_type)
            out.append(d)
        return out

    def close(self) -> None:
        with self._lock:
            self._conn.close()


@serde_struct
@dataclass
class ReportMetricsReq:
    node_id: int = 0
    node_type: str = ""
    ts: float = 0.0
    samples: list[dict] = field(default_factory=list)


@serde_struct
@dataclass
class ReportMetricsRsp:
    accepted: int = 0


@serde_struct
@dataclass
class QueryMetricsReq:
    name_prefix: str = ""
    since_ts: float = 0.0
    limit: int = 1000
    # appended (serde add-only): time/node bounds for incremental scans
    ts_max: float = 0.0            # EXCLUSIVE
    node_id: int = 0


@serde_struct
@dataclass
class QueryMetricsRsp:
    samples: list[dict] = field(default_factory=list)


@serde_struct
@dataclass
class ReportSpansReq:
    node_id: int = 0
    node_type: str = ""
    ts: float = 0.0
    spans: list[dict] = field(default_factory=list)


@serde_struct
@dataclass
class ReportSpansRsp:
    accepted: int = 0


@serde_struct
@dataclass
class QuerySpansReq:
    trace_id: int = 0
    name_prefix: str = ""
    min_dur_s: float = 0.0
    roots_only: bool = False
    limit: int = 1000
    # appended (serde add-only): arrival-time/node bounds for incremental
    # scans and `trace-slow --since`; ts_max is EXCLUSIVE
    ts_min: float = 0.0
    ts_max: float = 0.0
    node_id: int = 0


@serde_struct
@dataclass
class QuerySpansRsp:
    spans: list[dict] = field(default_factory=list)


@serde_struct
@dataclass
class QueryRollupsReq:
    ts_min: float = 0.0
    ts_max: float = 0.0            # EXCLUSIVE
    node_id: int = 0
    addr: str = ""
    method: str = ""
    limit: int = 100000


@serde_struct
@dataclass
class QueryRollupsRsp:
    rollups: list[dict] = field(default_factory=list)


@serde_struct
@dataclass
class HealthReq:
    window_s: float = 0.0          # 0 = monitor's configured window


@serde_struct
@dataclass
class HealthRsp:
    health: ClusterHealth | None = None


@serde_struct
@dataclass
class SloReportReq:
    window_s: float = 0.0


@serde_struct
@dataclass
class SloReportRsp:
    report: SloReport | None = None


@service("Monitor")
class MonitorCollectorService:
    def __init__(self, db: MetricsDB | None = None, clickhouse=None,
                 rollup=None, health_cfg: HealthConfig | None = None):
        self.db = db or MetricsDB()
        # optional production sink (clickhouse.py): reported
        # batches forward to ClickHouse with the ORIGIN node's identity,
        # sqlite stays for the admin CLI's local queries — the reference's
        # monitor_collector writes ClickHouse as its primary store
        self.clickhouse = clickhouse
        # health plane: RollupEngine ticked by the server; health/slo
        # queries answer from the rollups table
        self.rollup = rollup
        self.health_cfg = health_cfg or HealthConfig()

    @rpc_method
    async def report(self, req: ReportMetricsReq, payload, conn):
        ts = req.ts or time.time()
        n = self.db.insert(req.node_id, req.node_type, ts, req.samples)
        if self.clickhouse is not None:
            from t3fs_torch.monitor.clickhouse import samples_to_rows
            self.clickhouse.push_rows(samples_to_rows(
                req.node_id, req.node_type, ts, req.samples))
        return ReportMetricsRsp(n), b""

    @rpc_method
    async def query(self, req: QueryMetricsReq, payload, conn):
        return QueryMetricsRsp(
            self.db.query(req.name_prefix, req.since_ts, req.limit,
                          ts_max=req.ts_max, node_id=req.node_id)), b""

    @rpc_method
    async def report_spans(self, req: ReportSpansReq, payload, conn):
        n = self.db.insert_spans(req.node_id, req.node_type,
                                 req.ts or time.time(), req.spans)
        return ReportSpansRsp(n), b""

    @rpc_method
    async def query_spans(self, req: QuerySpansReq, payload, conn):
        return QuerySpansRsp(self.db.query_spans(
            req.trace_id, req.name_prefix, req.min_dur_s,
            req.roots_only, req.limit, ts_min=req.ts_min,
            ts_max=req.ts_max, node_id=req.node_id)), b""

    @rpc_method
    async def query_rollups(self, req: QueryRollupsReq, payload, conn):
        return QueryRollupsRsp(self.db.query_rollups(
            req.ts_min, req.ts_max, req.node_id, req.addr, req.method,
            req.limit)), b""

    @rpc_method
    async def health(self, req: HealthReq, payload, conn):
        """Scorecard over the last window.  Runs a rollup pass first so
        the answer includes everything reported up to now - lag — the
        freshness bound callers see is the rollup lag, not the timer
        period."""
        cfg = self.health_cfg
        if req.window_s > 0:
            cfg = replace(cfg, window_s=req.window_s)
        bucket_s = 1.0
        if self.rollup is not None:
            self.rollup.rollup_once()
            bucket_s = self.rollup.cfg.bucket_s
        return HealthRsp(scorecard_from_db(
            self.db, cfg=cfg, bucket_s=bucket_s)), b""

    @rpc_method
    async def slo_report(self, req: SloReportReq, payload, conn):
        cfg = self.health_cfg
        if req.window_s > 0:
            cfg = replace(cfg, window_s=req.window_s)
        if self.rollup is not None:
            self.rollup.rollup_once()
        return SloReportRsp(slo_from_db(self.db, cfg=cfg)), b""


class MonitorCollectorServer:
    """monitor_collector_main analog: the aggregation service as a server."""

    def __init__(self, db_path: str = ":memory:", host: str = "127.0.0.1",
                 port: int = 0, max_age_s: float = 0.0, max_rows: int = 0,
                 rollup_cfg=None, health_cfg: HealthConfig | None = None):
        from t3fs_torch.core.service import AppInfo, CoreService
        from t3fs_torch.monitor.rollup import RollupEngine
        from t3fs_torch.net.server import Server

        self.db = MetricsDB(db_path, max_age_s=max_age_s, max_rows=max_rows)
        self.rollup = RollupEngine(self.db, rollup_cfg)
        self.service = MonitorCollectorService(
            self.db, rollup=self.rollup, health_cfg=health_cfg)
        self.server = Server(host, port)
        self.server.add_service(self.service)
        self.core = CoreService(AppInfo(0, "monitor"))
        self.server.add_service(self.core)
        self._rollup_task = None

    async def start(self) -> None:
        import asyncio

        await self.server.start()
        self.core.app_info.address = self.server.address
        self._rollup_task = asyncio.create_task(self._rollup_loop())

    async def _rollup_loop(self) -> None:
        """Continuous aggregation tick: each pass folds only spans and
        metrics that arrived since the last one (arrival-ts high-water
        marks in the engine) — never a full-table rescan."""
        import asyncio
        import logging

        while True:
            await asyncio.sleep(self.rollup.cfg.period_s)
            try:
                self.rollup.rollup_once()
            except Exception:
                logging.getLogger("t3fs_torch.monitor").exception(
                    "rollup pass")

    async def stop(self) -> None:
        if self._rollup_task is not None:
            import logging

            from t3fs_torch.utils.aio import reap_task

            self._rollup_task.cancel()
            await reap_task(self._rollup_task,
                            logging.getLogger("t3fs_torch.monitor"),
                            "rollup loop")
            self._rollup_task = None
        await self.server.stop()
        self.db.close()

    @property
    def address(self) -> str:
        return self.server.address
