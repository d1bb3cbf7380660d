"""monitor_main: metric aggregation binary (reference:
src/monitor_collector/ monitor_collector_main).

The port of t3fs/app/monitor_main.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from t3fs_torch.app.base import ApplicationBase, LogConfig
from t3fs_torch.monitor.health import HealthConfig
from t3fs_torch.monitor.rollup import RollupConfig
from t3fs_torch.monitor.service import MonitorCollectorServer
from t3fs_torch.utils.config import ConfigBase, citem, cobj


@dataclass
class MonitorMainConfig(ConfigBase):
    listen_host: str = citem("127.0.0.1", hot=False)
    listen_port: int = citem(0, hot=False)
    db_path: str = citem(":memory:", hot=False)
    port_file: str = citem("", hot=False)
    # raw-table retention (0 = unbounded; rollups keep their own age cap)
    max_age_s: float = citem(0.0, hot=False)
    max_rows: int = citem(0, hot=False)
    # health plane: continuous rollup pass + scorecard knobs
    rollup: RollupConfig = cobj(RollupConfig)
    health: HealthConfig = cobj(HealthConfig)
    log: LogConfig = cobj(LogConfig)


async def serve(cfg: MonitorMainConfig, app: ApplicationBase) -> None:
    srv = MonitorCollectorServer(cfg.db_path, cfg.listen_host,
                                 cfg.listen_port, max_age_s=cfg.max_age_s,
                                 max_rows=cfg.max_rows,
                                 rollup_cfg=cfg.rollup,
                                 health_cfg=cfg.health)

    async def start():
        await srv.start()
        if cfg.port_file:
            # t3fslint: allow(blocking-in-async) — one-shot port-file write at startup
            with open(cfg.port_file, "w") as f:
                f.write(str(srv.server.port))

    await app.run(start, srv.stop)


def main(argv: list[str] | None = None) -> None:
    app = ApplicationBase("monitor", MonitorMainConfig)
    cfg = app.boot(argv)
    asyncio.run(serve(cfg, app))


if __name__ == "__main__":
    main()
