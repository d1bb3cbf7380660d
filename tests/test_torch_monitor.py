"""The port's health plane (t3fs_torch.monitor.{service,rollup,clickhouse,
reporter}, utils/mem.py, mgmtd's health puller and LocalCluster's
with_monitor) against the JAX package's: one seeded sequence of
ReportMetrics and ReportSpans calls into each package's
MonitorCollectorServer gives the same sqlite rows, rollups, ClickHouse rows
and scorecard, whichever package's client sends it; each package's mgmtd
puller gives the same routing piggyback; the port's reporter reaches the
reference's collector and back; and the port's LocalCluster runs the whole
plane, health_smoke's straggler flag and clear included.

time.time() is pinned in both packages' monitor modules to one instant with
monkeypatch, so every rollup pass and scorecard reads the same clock;
nothing in either package changes for it."""

import asyncio
import sqlite3
import time
import types as pytypes

import numpy as np
import pytest

import t3fs.kv.engine
import t3fs.mgmtd.service
import t3fs.monitor.clickhouse
import t3fs.monitor.health
import t3fs.monitor.reporter
import t3fs.monitor.rollup
import t3fs.monitor.service
import t3fs.net.client
import t3fs.net.server
import t3fs.utils.metrics
import t3fs.utils.serde
import t3fs_torch.kv.engine
import t3fs_torch.mgmtd.service
import t3fs_torch.monitor.clickhouse
import t3fs_torch.monitor.health
import t3fs_torch.monitor.reporter
import t3fs_torch.monitor.rollup
import t3fs_torch.monitor.service
import t3fs_torch.net.client
import t3fs_torch.net.server
import t3fs_torch.utils.metrics
import t3fs_torch.utils.serde


def _pkg(root) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, svc=root.monitor.service,
        rollup=root.monitor.rollup, health=root.monitor.health,
        ch=root.monitor.clickhouse, reporter=root.monitor.reporter,
        client=root.net.client, server=root.net.server,
        mgmtd=root.mgmtd.service, kv=root.kv.engine,
        metrics=root.utils.metrics, serde=root.utils.serde)


REF = _pkg(t3fs)
PORT = _pkg(t3fs_torch)
PKGS = {"ref": REF, "port": PORT}
READ = "Storage.batch_read"
NOW = float(int(time.time()) // 60 * 60)   # recent: rows are age-pruned
ADDRS = ("127.0.0.1:7001", "127.0.0.1:7002", "127.0.0.1:7003")


class _Clock:
    """The time module for the monitor modules: time() is NOW, always."""

    @staticmethod
    def time() -> float:
        return NOW


def pin_time(monkeypatch) -> None:
    for p in PKGS.values():
        for mod in (p.svc, p.rollup, p.health):
            monkeypatch.setattr(mod, "time", _Clock)


def _reports(seed: int = 2026) -> list[tuple[str, dict]]:
    """Seeded ReportSpans / ReportMetrics calls over 8 one-second buckets:
    three storage nodes serving reads, the third 10x slower in the last
    five, plus rpc.latency server_methods and gauge samples."""
    rng = np.random.default_rng(seed)
    calls = []
    for b in range(8):
        ts = NOW - 10.0 + b + 0.25
        for n, addr in enumerate(ADDRS, start=1):
            slow = 10.0 if (n == 3 and b >= 3) else 1.0
            spans = []
            for i in range(int(rng.integers(15, 30))):
                dur = float(rng.lognormal(np.log(0.002), 0.3)) * slow
                spans.append({
                    "trace_id": int(rng.integers(1, 1 << 40)),
                    "span_id": i + 1, "parent_id": 0, "name": READ,
                    "kind": "server", "t0": ts - dur, "dur_s": dur,
                    "status": int(rng.random() < 0.03) * 5, "root": 1,
                    "tags": {"addr": addr,
                             "wire_s": round(dur * 0.1, 9),
                             "queue_s": round(dur * 0.05, 9),
                             "bytes": int(rng.choice([4096, 1 << 20]))}})
            calls.append(("Monitor.report_spans",
                          dict(node_id=n, node_type="storage", ts=ts,
                               spans=spans)))
            samples = [
                {"name": "rpc.latency", "type": "rpc",
                 "server_methods": {READ: {
                     "count": int(rng.integers(40, 60)),
                     "errors": int(rng.integers(0, 3)),
                     "total_p50_ms": 2.0 * slow,
                     "total_p99_ms": float(rng.uniform(5, 9)) * slow}}},
                {"name": "mem.rss_bytes", "type": "value",
                 "value": int(rng.integers(1 << 28, 1 << 30)),
                 "tags": {"node_type": "storage", "node_id": str(n)}},
                {"name": "storage.write", "type": "latency",
                 "mean": float(rng.uniform(0.001, 0.01)), "count": 7}]
            calls.append(("Monitor.report",
                          dict(node_id=n, node_type="storage", ts=ts,
                               samples=samples)))
    return calls


def _health_cfg(p):
    return p.health.HealthConfig(window_s=30.0, freshness_s=60.0,
                                 m_trigger=3, m_clear=3)


def _rollup_cfg(p):
    # the loop never ticks in these tests: every pass is the one the
    # health RPC runs inline, at the pinned clock
    return p.rollup.RollupConfig(bucket_s=1.0, period_s=3600.0, lag_s=0.0)


def _dump_db(path: str) -> dict:
    con = sqlite3.connect(path)
    try:
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in ("metrics", "spans", "rollups")}
    finally:
        con.close()


def run_collector(server_pkg, client_pkg, db_path: str) -> dict:
    sp, cp = server_pkg, client_pkg
    calls = _reports()
    req_cls = {"Monitor.report_spans": cp.svc.ReportSpansReq,
               "Monitor.report": cp.svc.ReportMetricsReq}
    out = {}

    async def body():
        srv = sp.svc.MonitorCollectorServer(
            db_path, rollup_cfg=_rollup_cfg(sp), health_cfg=_health_cfg(sp))
        await srv.start()
        cli = cp.client.Client()
        try:
            for method, kw in calls:
                rsp, _ = await cli.call(srv.address, method,
                                        req_cls[method](**kw))
                assert rsp.accepted > 0
            rsp, _ = await cli.call(srv.address, "Monitor.health",
                                    cp.svc.HealthReq())
            out["health"] = cp.serde.dumps(rsp.health)
            h = rsp.health
            out["stragglers"] = sorted(n.addr for n in h.nodes
                                       if n.straggler)
            rsp, _ = await cli.call(srv.address, "Monitor.query_rollups",
                                    cp.svc.QueryRollupsReq())
            out["rollups"] = rsp.rollups
            rsp, _ = await cli.call(srv.address, "Monitor.query",
                                    cp.svc.QueryMetricsReq(limit=100000))
            out["metrics"] = rsp.samples
            rsp, _ = await cli.call(srv.address, "Monitor.query_spans",
                                    cp.svc.QuerySpansReq(
                                        name_prefix="Storage.",
                                        min_dur_s=0.01, limit=100000))
            out["slow_spans"] = rsp.spans
            rsp, _ = await cli.call(srv.address, "Monitor.slo_report",
                                    cp.svc.SloReportReq(window_s=30.0))
            out["slo"] = cp.serde.dumps(rsp.report)
        finally:
            await cli.close()
            await srv.stop()

    asyncio.run(body())
    out["db"] = _dump_db(db_path)
    out["clickhouse"] = [sp.ch.samples_to_rows(kw["node_id"],
                                               kw["node_type"], kw["ts"],
                                               kw["samples"])
                         for m, kw in calls if m == "Monitor.report"]
    return out


@pytest.mark.parametrize("client", ["ref", "port"])
def test_collector_rows_rollups_scorecard_equal(tmp_path, monkeypatch,
                                                client):
    pin_time(monkeypatch)
    ref = run_collector(REF, PKGS[client], str(tmp_path / "ref.sqlite"))
    port = run_collector(PORT, PKGS[client], str(tmp_path / "port.sqlite"))
    # the sequence means something: the slow node is flagged, rollups
    # hold both sources, every call landed
    assert ref["stragglers"] == [ADDRS[2]]
    assert {r["addr"] for r in ref["rollups"]} == {"", *ADDRS}
    assert len(ref["db"]["metrics"]) == 8 * 3 * 3
    assert ref["slow_spans"]
    for key in ("health", "stragglers", "rollups", "metrics", "slow_spans",
                "slo", "db", "clickhouse"):
        assert port[key] == ref[key], key


def run_puller(p) -> tuple[bytes, list]:
    """A monitor of package p holding the seeded reports, and p's mgmtd
    pulling from it: the scorecard the routing piggyback carries."""
    calls = _reports()

    async def body():
        mon = p.svc.MonitorCollectorServer(rollup_cfg=_rollup_cfg(p),
                                           health_cfg=_health_cfg(p))
        await mon.start()
        for method, kw in calls:
            if method == "Monitor.report_spans":
                mon.db.insert_spans(kw["node_id"], kw["node_type"],
                                    kw["ts"], kw["spans"])
            else:
                mon.db.insert(kw["node_id"], kw["node_type"], kw["ts"],
                              kw["samples"])
        cfg = p.mgmtd.MgmtdConfig(monitor_address=mon.address,
                                  health_pull_period_s=0.02,
                                  health_window_s=30.0)
        rpc = p.server.Server()
        srv = p.mgmtd.MgmtdServer(p.kv.MemKVEngine(), 1, "", cfg)
        for svc in srv.services:
            rpc.add_service(svc)
        await rpc.start()
        await srv.start()
        cli = p.client.Client()
        try:
            assert any(t.get_name() == "mgmtd-health" for t in srv._tasks)
            for _ in range(500):
                if srv.state.health_version:
                    break
                await asyncio.sleep(0.01)
            assert srv.state.health_version > 0
            rsp, _ = await cli.call(rpc.address, "Mgmtd.get_routing_info",
                                    p.mgmtd.GetRoutingInfoReq())
            assert rsp.health_version >= 1
            # up to date: no re-send
            again, _ = await cli.call(
                rpc.address, "Mgmtd.get_routing_info",
                p.mgmtd.GetRoutingInfoReq(
                    known_health_version=srv.state.health_version + 1))
            assert again.health is None
            return (p.serde.dumps(rsp.health),
                    sorted(n.addr for n in rsp.health.nodes if n.straggler))
        finally:
            await cli.close()
            await srv.stop()
            await rpc.stop()
            await mon.stop()

    return asyncio.run(body())


def test_mgmtd_health_puller_piggyback_equal(monkeypatch):
    pin_time(monkeypatch)
    ref = run_puller(REF)
    port = run_puller(PORT)
    assert ref[1] == [ADDRS[2]]
    assert port == ref


@pytest.mark.parametrize("reporter_pkg,collector_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_reporter_reaches_the_other_packages_collector(reporter_pkg,
                                                       collector_pkg):
    rp, cp = PKGS[reporter_pkg], PKGS[collector_pkg]

    async def body():
        srv = cp.svc.MonitorCollectorServer()
        await srv.start()
        rp.metrics.reset_registry()
        rep = rp.reporter.MonitorReporter(srv.address, node_id=7,
                                          node_type="storage")
        try:
            c = rp.metrics.CountRecorder("pipeline.ops")
            c.add(41)
            rp.metrics.Collector(period_s=3600,
                                 reporters=[rep]).collect_once()
            cli = cp.client.Client()
            rows = []
            for _ in range(100):   # the reporter's thread is async
                rsp, _ = await cli.call(
                    srv.address, "Monitor.query",
                    cp.svc.QueryMetricsReq(name_prefix="pipeline."))
                rows = rsp.samples
                if rows:
                    break
                await asyncio.sleep(0.05)
            await cli.close()
            assert rows and rows[0]["value"] == 41
            assert (rows[0]["node_id"], rows[0]["node_type"]) == (
                7, "storage")
        finally:
            rep.close()
            rp.metrics.reset_registry()
            await srv.stop()

    asyncio.run(body())


def test_memory_watcher_gauges_match_reference():
    from t3fs.utils.mem import MemoryWatcher as RefWatcher
    from t3fs_torch.utils.mem import MemoryWatcher

    names = []
    for cls, p in ((RefWatcher, REF), (MemoryWatcher, PORT)):
        p.metrics.reset_registry()
        try:
            w = cls(tags={"node_type": "test"})
            snap = p.metrics.Collector(period_s=60,
                                       samplers=[w.sample]).collect_once()
            rss = [r for r in snap if r["name"] == "mem.rss_bytes"][0]
            assert rss["value"] > 1 << 20
            names.append(sorted(r["name"] for r in snap
                                if r["name"].startswith("mem.")))
        finally:
            p.metrics.reset_registry()
    assert names[0] == names[1] and len(names[0]) == 4


def test_local_cluster_with_monitor_seeds_cold_client():
    """The port's LocalCluster(with_monitor=True): reads -> spans ->
    rollups -> scorecard -> mgmtd cache -> GetRoutingInfoRsp piggyback ->
    a cold client's ReadStats priors, as the reference's test of the same
    name does on its own cluster."""
    from t3fs_torch.client.mgmtd_client import MgmtdClient
    from t3fs_torch.net.rpcstats import READ_STATS
    from t3fs_torch.storage.types import ChunkId, ReadIO
    from t3fs_torch.testing.cluster import LocalCluster
    from t3fs_torch.utils import tracing
    from t3fs_torch.utils.tracing import TraceConfig

    async def body():
        tracing.reset_tracing()
        cl = LocalCluster(
            num_nodes=3, replicas=3, with_monitor=True,
            heartbeat_timeout_s=60.0, checksum_backend="cpu",
            trace=TraceConfig(sample_rate=1.0, export="all"),
            rollup_cfg=PORT.rollup.RollupConfig(bucket_s=0.25, period_s=0.1,
                                                lag_s=0.05),
            seed_read_priors=False)
        await cl.start()
        try:
            assert cl.mgmtd_cfg.monitor_address == cl.monitor.address
            cid = ChunkId(0x4EA17, 0)
            await cl.sc.write_chunk(1, cid, 0, b"\xcd" * 4096, 4096)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                for _ in range(20):
                    await cl.sc.batch_read(
                        [ReadIO(chain_id=1, chunk_id=cid, offset=0,
                                length=4096)])
                    await asyncio.sleep(0.002)
                h = cl.mgmtd.state.health
                if h is not None and any(n.count for n in h.nodes):
                    break
            else:
                raise AssertionError("mgmtd never cached a scorecard")
            assert cl.mgmtd.state.health_version > 0
            # addr -> node_id resolution against the routing table
            node_ids = {n.node_id for n in cl.mgmtd.state.health.nodes
                        if n.count}
            assert node_ids and node_ids <= set(cl.storage)
            READ_STATS.clear()
            mc = MgmtdClient(cl.mgmtd_rpc.address, refresh_period_s=3600.0,
                             seed_read_priors=True)
            try:
                await mc.refresh()
                assert mc.health is not None
                seeded = {a for a, s in READ_STATS.snapshot().items()
                          if s["seeded"]}
                assert seeded and seeded <= {
                    n.addr for n in mc.health.nodes if n.count}
            finally:
                await mc.stop()
        finally:
            await cl.stop()
            READ_STATS.clear()
            tracing.reset_tracing()
        assert cl.monitor is None and cl.reporter is None

    asyncio.run(body())


def test_health_smoke_flags_and_clears():
    """health_smoke at the CPU's size: a 10 ms straggler on node 2 is
    flagged, then cleared, each within the reference's bounds."""
    from t3fs_torch.benchmarks import health_smoke

    got = asyncio.run(health_smoke.measure("cpu"))
    assert got["ok"], got
    assert got["flagged_s"] <= got["detect_bound_s"]
    assert got["cleared_s"] <= got["clear_bound_s"]
