"""Node-side reporter pushing Collector snapshots to monitor_collector.

Reference analog: common/monitor/MonitorCollectorClient — each server's
Collector::periodicallyCollect pushes samples to the monitor_collector
service over the normal RPC fabric.  The Collector samples on a plain
thread, so this reporter runs its own event loop thread and forwards
snapshots without blocking the sampler; a slow/unreachable collector drops
snapshots (bounded queue) rather than stalling metrics.

The port of t3fs/monitor/reporter.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time

from t3fs_torch.monitor.service import ReportMetricsReq, ReportSpansReq
from t3fs_torch.net.client import Client
from t3fs_torch.utils import tracing

log = logging.getLogger("t3fs_torch.monitor")


class MonitorReporter:
    """Callable usable in Collector(reporters=[...])."""

    def __init__(self, address: str, node_id: int = 0, node_type: str = "",
                 max_queued: int = 16):
        self.address = address
        self.node_id = node_id
        self.node_type = node_type
        self._q: queue.Queue = queue.Queue(maxsize=max_queued)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="t3fs-monitor-reporter")
        self._thread.start()
        self.dropped = 0

    def __call__(self, snapshot: list[dict]) -> None:
        try:
            # error=True rows are failed CallbackGauge pulls: their 0.0 is
            # not a measurement, so they never reach the sink
            self._q.put_nowait([s for s in snapshot if not s.get("error")])
        except queue.Full:
            self.dropped += 1

    def _run(self) -> None:
        asyncio.run(self._loop())

    async def _loop(self) -> None:
        cli = Client()
        try:
            while not self._stop.is_set():
                try:
                    snap = self._q.get(timeout=0.2)
                except queue.Empty:
                    snap = ()   # idle tick: still drain promoted spans
                if snap is None:
                    break
                if snap:
                    try:
                        await cli.call(
                            self.address, "Monitor.report",
                            ReportMetricsReq(self.node_id, self.node_type,
                                             time.time(), list(snap)),
                            timeout=5.0)
                    except Exception as e:
                        log.warning("metric push to %s failed: %s",
                                    self.address, e)
                await self._push_spans(cli)
        finally:
            await cli.close()

    async def _push_spans(self, cli: Client) -> None:
        """Drain tail-promoted spans (tracing.BUFFER) to the collector;
        the queue tick bounds push latency at ~0.2s."""
        spans = tracing.BUFFER.drain()
        while spans:
            try:
                await cli.call(
                    self.address, "Monitor.report_spans",
                    ReportSpansReq(self.node_id, self.node_type,
                                   time.time(), spans),
                    timeout=5.0)
            except Exception as e:
                log.warning("span push to %s failed: %s", self.address, e)
                return   # spans dropped; next tick starts fresh
            spans = tracing.BUFFER.drain()

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=3)
