"""ClickHouse metric sink: the production analog of the sqlite MetricsDB.

Reference analog: src/common/monitor/ClickHouseClient.h — every server's
monitor chain can write samples straight into ClickHouse, and
monitor_collector does the same for pushed samples.  t3fs speaks
ClickHouse's HTTP interface directly (POST /?query=INSERT ... FORMAT
JSONEachRow — stable since ClickHouse 1.x, no client library needed), so
the sink works against a real ClickHouse at :8123 and is testable against
a 40-line fake (tests/test_monitor.py).

Row shape matches deploy/sql/t3fs-monitor-clickhouse.sql: one row per
recorder sample per collection tick, full snapshot JSON in `payload` —
the same columns the sqlite DDL (deploy/sql/t3fs-monitor.sql) defines, so
queries port across dev (sqlite) and prod (ClickHouse) unchanged.

Delivery model (mirrors MonitorReporter): a dedicated thread owns the
connection; callers enqueue and never block; a bounded queue drops under
sustained sink outage (metrics are lossy-by-design — stalling the server
to preserve a gauge is the wrong trade, ClickHouseClient behaves the
same); failed batches are retried once on a fresh connection (half-open
keep-alive sockets) and then dropped with a counter.

The port of t3fs/monitor/clickhouse.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.parse

log = logging.getLogger("t3fs_torch.monitor")

_TABLE_COLUMNS = ("ts", "node_id", "node_type", "name", "kind", "value",
                  "payload")


def samples_to_rows(node_id: int, node_type: str, ts: float,
                    samples: list[dict]) -> list[dict]:
    """One JSONEachRow dict per sample (shared by sink and tests so the
    wire shape and the DDL cannot drift)."""
    rows = []
    for s in samples:
        value = s.get("value", s.get("mean"))
        rows.append({
            "ts": ts,
            "node_id": node_id,
            "node_type": node_type,
            "name": s.get("name", ""),
            "kind": s.get("type", ""),
            "value": float(value) if value is not None else None,
            "payload": json.dumps(s, default=str),
        })
    return rows


class ClickHouseClient:
    """Minimal ClickHouse HTTP-interface client (INSERT + ping).

    Blocking by design — it runs on the sink's own thread, exactly like
    the reference's ClickHouseClient runs on the monitor flush thread.
    A fresh socket per call: keep-alive would be marginally faster, but a
    half-open connection after a ClickHouse restart turns every flush
    into a timeout hang; metrics prefer predictable."""

    def __init__(self, host: str, port: int = 8123, *,
                 database: str = "t3fs_monitor", table: str = "metrics",
                 user: str = "", password: str = "",
                 timeout_s: float = 5.0):
        self.host, self.port = host, port
        self.database, self.table = database, table
        self.user, self.password = user, password
        self.timeout_s = timeout_s

    def _request(self, query: str, body: bytes) -> tuple[int, bytes]:
        import socket
        qs = urllib.parse.urlencode({"query": query,
                                     "database": self.database})
        headers = [f"POST /?{qs} HTTP/1.1",
                   f"Host: {self.host}:{self.port}",
                   f"Content-Length: {len(body)}",
                   "Connection: close"]
        if self.user:
            headers.append(f"X-ClickHouse-User: {self.user}")
        if self.password:
            headers.append(f"X-ClickHouse-Key: {self.password}")
        raw = ("\r\n".join(headers) + "\r\n\r\n").encode() + body
        with socket.create_connection((self.host, self.port),
                                      timeout=self.timeout_s) as sock:
            sock.sendall(raw)
            sock.settimeout(self.timeout_s)
            buf = b""
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
            head, _, rest = buf.partition(b"\r\n\r\n")
            status = int(head.split(b" ", 2)[1]) if head else 0
            clen = 0
            for line in head.split(b"\r\n")[1:]:
                k, _, v = line.partition(b":")
                if k.strip().lower() == b"content-length":
                    clen = int(v.strip())
            # drain the advertised body (error text) for the log line
            while len(rest) < clen:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                rest += chunk
            return status, rest[:clen]

    def insert_rows(self, rows: list[dict]) -> None:
        """INSERT ... FORMAT JSONEachRow; raises on non-200."""
        if not rows:
            return
        body = b"".join(json.dumps(r, default=str).encode() + b"\n"
                        for r in rows)
        query = (f"INSERT INTO {self.table} "
                 f"({', '.join(_TABLE_COLUMNS)}) FORMAT JSONEachRow")
        status, err = self._request(query, body)
        if status != 200:
            raise RuntimeError(
                f"clickhouse insert -> HTTP {status}: {err[:200]!r}")

    def ping(self) -> bool:
        try:
            status, _ = self._request("SELECT 1", b"")
            return status == 200
        except OSError:
            return False


class ClickHouseReporter:
    """Callable usable in Collector(reporters=[...]) — the direct-write
    production path (each server -> ClickHouse, no collector service in
    between), same seam as MonitorReporter.  Also accepts pre-shaped
    rows via push_rows() (the monitor_collector forwarding path, where
    rows carry the ORIGIN node's identity, not this process's)."""

    def __init__(self, client: ClickHouseClient, node_id: int = 0,
                 node_type: str = "", max_queued: int = 64):
        self.client = client
        self.node_id = node_id
        self.node_type = node_type
        self._q: queue.Queue = queue.Queue(maxsize=max_queued)
        self._stop = threading.Event()
        self.dropped = 0
        self.inserted = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="t3fs-clickhouse-reporter")
        self._thread.start()

    def __call__(self, snapshot: list[dict]) -> None:
        self.push_rows(samples_to_rows(self.node_id, self.node_type,
                                       time.time(), list(snapshot)))

    def push_rows(self, rows: list[dict]) -> None:
        if not rows:
            return
        try:
            self._q.put_nowait(rows)
        except queue.Full:
            self.dropped += len(rows)

    def _run(self) -> None:
        while True:
            try:
                rows = self._q.get(timeout=0.2)
            except queue.Empty:
                if self._stop.is_set():
                    return          # stop only once the queue drained
                continue
            for attempt in (1, 2):      # one retry on a fresh connection
                try:
                    self.client.insert_rows(rows)
                    self.inserted += len(rows)
                    break
                except Exception as e:
                    if attempt == 2:
                        self.dropped += len(rows)
                        log.warning("clickhouse insert failed twice, "
                                    "dropping %d rows: %s", len(rows), e)

    def close(self) -> None:
        """Flush-then-stop: queued batches are delivered before the
        thread exits (a server shutting down should not lose its final
        tick), bounded by the joins below."""
        self._stop.set()
        self._thread.join(timeout=10)
