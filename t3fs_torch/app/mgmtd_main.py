"""mgmtd_main: cluster manager binary (reference: src/mgmtd/mgmtd.cpp).

    python -m t3fs_torch.app.mgmtd_main --config configs/mgmtd.toml

The port of t3fs/app/mgmtd_main.py, a copy with its imports re-pointed: the
port's open_kv_engine takes "mem" and "wal:" specs.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from t3fs_torch.app.base import ApplicationBase, LogConfig
from t3fs_torch.kv.wal_engine import open_kv_engine
from t3fs_torch.mgmtd.service import MgmtdConfig, MgmtdServer
from t3fs_torch.net.server import Server
from t3fs_torch.utils.config import ConfigBase, citem, cobj


@dataclass
class MgmtdMainConfig(ConfigBase):
    node_id: int = citem(1, hot=False)
    listen_host: str = citem("127.0.0.1", hot=False)
    listen_port: int = citem(0, hot=False)
    kv: str = citem("mem", hot=False)       # open_kv_engine spec
    admin_token: str = citem("", hot=False)
    port_file: str = citem("", hot=False)   # write bound port here (dev clusters)
    monitor_address: str = citem("", hot=False)   # push metrics here
    metrics_period_s: float = citem(10.0, hot=False)
    service: MgmtdConfig = cobj(MgmtdConfig)
    log: LogConfig = cobj(LogConfig)


async def serve(cfg: MgmtdMainConfig, app: ApplicationBase) -> None:
    kv = open_kv_engine(cfg.kv)
    rpc = Server(cfg.listen_host, cfg.listen_port)

    mgmtd: list[MgmtdServer] = []

    async def start():
        await rpc.start()
        # default the health puller at the same monitor the metrics go
        # to, unless [service] pins its own
        if cfg.monitor_address and not cfg.service.monitor_address:
            cfg.service.monitor_address = cfg.monitor_address
        srv = MgmtdServer(kv, cfg.node_id, rpc.address, cfg.service,
                          admin_token=cfg.admin_token)
        for svc in srv.services:
            rpc.add_service(svc)
        await srv.start()
        mgmtd.append(srv)
        app.start_metrics(cfg.monitor_address, cfg.node_id,
                          cfg.metrics_period_s)
        if cfg.port_file:
            # t3fslint: allow(blocking-in-async) — one-shot port-file write at startup
            with open(cfg.port_file, "w") as f:
                f.write(str(rpc.port))

    async def stop():
        if mgmtd:
            await mgmtd[0].stop()
        await rpc.stop()
        if hasattr(kv, "close"):
            kv.close()

    await app.run(start, stop)


def main(argv: list[str] | None = None) -> None:
    app = ApplicationBase("mgmtd", MgmtdMainConfig)
    cfg = app.boot(argv)
    asyncio.run(serve(cfg, app))


if __name__ == "__main__":
    main()
