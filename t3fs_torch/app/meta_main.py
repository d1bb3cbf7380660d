"""meta_main: metadata service binary (reference: src/meta/meta.cpp,
TwoPhaseApplication<MetaServer>).

Stateless against its transactional KV (the reference's FoundationDB role is
played by the WAL engine spec in [kv]); talks to mgmtd for routing and to
storage for GC / length queries.

The port of t3fs/app/meta_main.py, a copy with its imports re-pointed.  A
non-empty event_trace_path opens the Parquet sink, which needs pyarrow: where
it is missing the process fails at startup rather than drop the trace.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from t3fs_torch.app.base import ApplicationBase, LogConfig
from t3fs_torch.client.mgmtd_client import MgmtdClientForServer
from t3fs_torch.mgmtd.types import NodeInfo
from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
from t3fs_torch.kv.wal_engine import open_kv_engine
from t3fs_torch.meta.service import MetaServer
from t3fs_torch.meta.store import ChainAllocator, MetaStore
from t3fs_torch.net.server import Server
from t3fs_torch.utils.config import ConfigBase, citem, cobj


@dataclass
class MetaMainConfig(ConfigBase):
    node_id: int = citem(0, hot=False)
    listen_host: str = citem("127.0.0.1", hot=False)
    listen_port: int = citem(0, hot=False)
    # compress RPC frames >= this size (0 = off; UseCompress analog)
    compress_threshold: int = citem(0, hot=False)
    mgmtd_address: str = citem("127.0.0.1:9000", hot=False)
    kv: str = citem("mem", hot=False)
    default_chunk_size: int = citem(1 << 20, hot=False,
                                    validator=lambda v: v > 0)
    stripe_size: int = citem(1, hot=False, validator=lambda v: v >= 1)
    gc_period_s: float = citem(0.5, validator=lambda v: v > 0)
    session_ttl_s: float = citem(3600.0, validator=lambda v: v > 0)
    admin_token: str = citem("", hot=False)
    port_file: str = citem("", hot=False)
    # meta event trace -> Parquet (src/meta/event/Event.h analog); empty
    # keeps the JSON log-line mirror only
    event_trace_path: str = citem("", hot=False)
    monitor_address: str = citem("", hot=False)   # push metrics here
    metrics_period_s: float = citem(10.0, hot=False)
    log: LogConfig = cobj(LogConfig)


async def serve(cfg: MetaMainConfig, app: ApplicationBase) -> None:
    import time as _time

    kv = open_kv_engine(cfg.kv)
    rpc = Server(cfg.listen_host, cfg.listen_port,
                 compress_threshold=cfg.compress_threshold)
    # ForServer role: meta nodes REGISTER with mgmtd so peers (and the
    # Distributor) can see the live meta-server set
    mgmtd = MgmtdClientForServer(
        cfg.mgmtd_address,
        NodeInfo(cfg.node_id, "", node_type="meta",
                 generation=_time.time()),
        lambda: {})
    state: dict = {}

    async def start():
        from t3fs_torch.mgmtd.types import NodeStatus

        sc = StorageClient(mgmtd.routing, config=StorageClientConfig(),
                           refresh_routing=mgmtd.refresh)
        from t3fs_torch.meta.events import MetaEventLog
        store = MetaStore(kv, ChainAllocator(
            mgmtd.routing, default_chunk_size=cfg.default_chunk_size,
            default_stripe=cfg.stripe_size),
            event_log=MetaEventLog(cfg.event_trace_path or None))
        async def live_clients():
            """Live client ids from mgmtd (MgmtdClientSessionsChecker input);
            None on failure -> pruner falls back to TTL-only."""
            try:
                rsp, _ = await mgmtd.client.call(
                    cfg.mgmtd_address, "Mgmtd.list_client_sessions", None,
                    timeout=5.0)
                return {s.client_id for s in rsp.sessions}
            except Exception:
                return None

        meta = MetaServer(store, sc, gc_period_s=cfg.gc_period_s,
                          session_ttl_s=cfg.session_ttl_s,
                          node_id=cfg.node_id, admin_token=cfg.admin_token,
                          live_clients_provider=live_clients,
                          # ACTIVE-only: a decommissioned meta server must
                          # not own Distributor duties forever (mgmtd marks
                          # dead non-storage nodes FAILED)
                          meta_servers_provider=lambda: [
                              n.node_id
                              for n in mgmtd.routing().nodes.values()
                              if n.node_type == "meta"
                              and n.status == NodeStatus.ACTIVE])
        # register every service BEFORE the socket opens: a half-started
        # server answering RPC_METHOD_NOT_FOUND (non-retryable) is worse
        # than a connection refused (retryable)
        for svc in meta.services:
            rpc.add_service(svc)
        await rpc.start()
        mgmtd.node.address = rpc.address
        await mgmtd.start()
        await meta.start()
        app.start_metrics(cfg.monitor_address, cfg.node_id,
                          cfg.metrics_period_s)
        state["meta"], state["sc"] = meta, sc
        if cfg.port_file:
            # t3fslint: allow(blocking-in-async) — one-shot port-file write at startup
            with open(cfg.port_file, "w") as f:
                f.write(str(rpc.port))

    async def stop():
        if "meta" in state:
            await state["meta"].stop()
            if state["meta"].store.events is not None:
                state["meta"].store.events.close()
        await rpc.stop()
        if "sc" in state:
            await state["sc"].close()
        await mgmtd.stop()
        if hasattr(kv, "close"):
            kv.close()

    await app.run(start, stop)


def main(argv: list[str] | None = None) -> None:
    app = ApplicationBase("meta", MetaMainConfig)
    cfg = app.boot(argv)
    asyncio.run(serve(cfg, app))


if __name__ == "__main__":
    main()
