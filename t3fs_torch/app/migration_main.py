"""migration_main: target-migration orchestration binary (reference:
src/migration/ migration_main — a stub there; a real service here, see
t3fs_torch/migration/service.py).

    python -m t3fs_torch.app.migration_main --set mgmtd_address=HOST:PORT \
        --set rebalance=true --set rebalance_budget_mbps=64

The port of t3fs/app/migration_main.py, a copy with its imports re-pointed.
It runs no device work: the chunks a move streams are checksummed by the
destination storage node's backend (B1 on the card by default).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from t3fs_torch.app.base import ApplicationBase, LogConfig
from t3fs_torch.migration.service import MigrationService
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.utils.config import ConfigBase, citem, cobj


@dataclass
class MigrationMainConfig(ConfigBase):
    listen_host: str = citem("127.0.0.1", hot=False)
    listen_port: int = citem(0, hot=False)
    mgmtd_address: str = citem("127.0.0.1:9000", hot=False)
    sync_timeout_s: float = citem(3600.0, validator=lambda v: v > 0)
    # how long a move tolerates its destination node being dead before
    # failing resumable (the flap bound)
    flap_timeout_s: float = citem(10.0, validator=lambda v: v > 0)
    # JSON job store: a restarted daemon re-attaches to in-flight jobs
    # (empty = in-memory only)
    store_path: str = citem("", hot=False)
    # rebalancer: 0 budget still paces nothing but the planner
    # runs; rebalance=false leaves the service submit-only (operator jobs)
    rebalance: bool = citem(False, hot=False)
    rebalance_budget_mbps: float = citem(0.0, validator=lambda v: v >= 0)
    rebalance_period_s: float = citem(2.0, validator=lambda v: v > 0)
    rebalance_max_inflight: int = citem(2, validator=lambda v: v >= 1)
    port_file: str = citem("", hot=False)
    log: LogConfig = cobj(LogConfig)


async def serve(cfg: MigrationMainConfig, app: ApplicationBase) -> None:
    from t3fs_torch.migration.rebalancer import Rebalancer
    cli = Client()
    svc = MigrationService(cfg.mgmtd_address, client=cli,
                           sync_timeout_s=cfg.sync_timeout_s,
                           flap_timeout_s=cfg.flap_timeout_s,
                           store_path=cfg.store_path)
    srv = Server(cfg.listen_host, cfg.listen_port)
    srv.add_service(svc)
    reb = Rebalancer(svc, budget_mbps=cfg.rebalance_budget_mbps,
                     plan_period_s=cfg.rebalance_period_s,
                     max_inflight=cfg.rebalance_max_inflight) \
        if cfg.rebalance else None
    if reb is not None:
        srv.add_service(reb)

    async def start():
        await srv.start()
        await svc.start()            # re-attach to stored in-flight jobs
        if reb is not None:
            await reb.start()
        if cfg.port_file:
            # t3fslint: allow(blocking-in-async) — one-shot port-file write at startup
            with open(cfg.port_file, "w") as f:
                f.write(str(srv.port))

    async def stop():
        if reb is not None:
            await reb.stop()
        await svc.stop()
        await srv.stop()
        await cli.close()

    await app.run(start, stop)


def main(argv: list[str] | None = None) -> None:
    app = ApplicationBase("migration", MigrationMainConfig)
    cfg = app.boot(argv)
    asyncio.run(serve(cfg, app))


if __name__ == "__main__":
    main()
