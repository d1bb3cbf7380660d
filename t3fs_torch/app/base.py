"""Application bootstrap shared by every server binary.

Reference analogs: common/app/ApplicationBase.h:15-72 (parseFlags,
initApplication, mainLoop, onConfigUpdated), TwoPhaseApplication.h:15-46
(launcher fetches the config template from mgmtd, merges, then starts the
server), common/logging/LogConfig.h (TOML-driven rotating file logging,
normal/err split as in configs/storage_main.toml:1-40).

Usage (each *_main module):
    app = ApplicationBase("storage", StorageMainConfig)
    cfg = app.boot(argv)          # flags + TOML + optional mgmtd template
    asyncio.run(app.run(main(cfg)))   # signal-aware main loop

The port of t3fs/app/base.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import logging.handlers
import signal
import sys
from dataclasses import dataclass

from t3fs_torch.utils.config import ConfigBase, citem

log = logging.getLogger("t3fs_torch.app")


@dataclass
class LogConfig(ConfigBase):
    """[log] section (common/logging/LogConfig.h analog)."""
    level: str = citem("INFO")
    file: str = citem("", hot=False)          # empty -> stderr
    err_file: str = citem("", hot=False)      # extra WARNING+ sink
    rotate_bytes: int = citem(64 << 20, hot=False)
    backups: int = citem(4, hot=False)


def setup_logging(cfg: LogConfig, name: str) -> None:
    root = logging.getLogger()
    root.setLevel(getattr(logging, cfg.level.upper(), logging.INFO))
    fmt = logging.Formatter(
        f"%(asctime)s %(levelname).1s [{name}] %(name)s: %(message)s")
    handlers: list[logging.Handler] = []
    if cfg.file:
        handlers.append(logging.handlers.RotatingFileHandler(
            cfg.file, maxBytes=cfg.rotate_bytes, backupCount=cfg.backups))
    else:
        handlers.append(logging.StreamHandler(sys.stderr))
    if cfg.err_file:
        errh = logging.handlers.RotatingFileHandler(
            cfg.err_file, maxBytes=cfg.rotate_bytes, backupCount=cfg.backups)
        errh.setLevel(logging.WARNING)
        handlers.append(errh)
    root.handlers.clear()
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)


def parse_overrides(pairs: list[str]) -> dict:
    """--set a.b=3 style overrides; values parsed as TOML scalars."""
    try:
        import tomllib
    except ImportError:
        import tomli as tomllib  # type: ignore[no-redef]
    out = {}
    for pair in pairs:
        key, eq, raw = pair.partition("=")
        if not eq or not key.strip():
            raise SystemExit(f"--set needs key=value, got {pair!r}")
        if not raw:
            out[key.strip()] = ""   # explicit empty value is legitimate
            continue
        try:
            val = tomllib.loads(f"v = {raw}")["v"]
        except tomllib.TOMLDecodeError:
            val = raw  # bare string
        out[key.strip()] = val
    return out


class ApplicationBase:
    def __init__(self, node_type: str, config_cls: type[ConfigBase]):
        self.node_type = node_type
        self.config_cls = config_cls
        self.cfg: ConfigBase | None = None
        self._collector = None
        self._reporter = None

    def start_metrics(self, monitor_address: str = "", node_id: int = 0,
                      period_s: float = 10.0) -> None:
        """Start the per-process metric Collector: memory gauges sampled
        each tick (src/memory AllocatedMemoryCounter analog), snapshots
        pushed to monitor_collector when an address is configured, logged
        otherwise (Collector::periodicallyCollect, Monitor.h:22,92)."""
        from t3fs_torch.monitor.reporter import MonitorReporter
        from t3fs_torch.utils.mem import MemoryWatcher
        from t3fs_torch.utils.metrics import Collector

        watcher = MemoryWatcher(tags={"node_type": self.node_type,
                                      "node_id": str(node_id)})
        reporters = None
        if monitor_address:
            # per-method RPC latency splits ride the same pipeline (the
            # rpc-top data, queryable from the monitor sink over time).
            # Only when a monitor exists: the log fallback drops
            # payload-only rows, so the snapshot work would go nowhere.
            from t3fs_torch.net.rpcstats import register_monitor_recorder
            register_monitor_recorder()
            self._reporter = MonitorReporter(monitor_address, node_id,
                                             self.node_type)
            reporters = [self._reporter]
        self._collector = Collector(period_s=period_s, reporters=reporters,
                                    samplers=[watcher.sample])
        self._collector.start()

    def stop_metrics(self) -> None:
        if self._collector is not None:
            self._collector.stop()
            self._collector = None
        if self._reporter is not None:
            self._reporter.close()   # its thread + TCP conn to the monitor
            self._reporter = None

    def boot(self, argv: list[str] | None = None) -> ConfigBase:
        ap = argparse.ArgumentParser(prog=f"t3fs-{self.node_type}")
        ap.add_argument("--config", help="TOML config file")
        ap.add_argument("--set", action="append", default=[],
                        metavar="KEY=VAL", help="config override (repeatable)")
        ap.add_argument("--fetch-config-from",
                        metavar="MGMTD_ADDR",
                        help="two-phase launch: pull the config template for "
                             "this node type from mgmtd, then apply local "
                             "file/--set overrides on top")
        args = ap.parse_args(argv)

        base: ConfigBase = self.config_cls()
        if args.fetch_config_from:
            toml_text = asyncio.run(
                self._fetch_template(args.fetch_config_from))
            if toml_text:
                base = self.config_cls.from_toml(toml_text)
        if args.config:
            # apply ONLY the keys present in the file — dumping a parsed
            # config object would clobber template values with defaults
            try:
                import tomllib
            except ImportError:
                import tomli as tomllib  # type: ignore[no-redef]
            with open(args.config, "rb") as f:
                base.update(tomllib.load(f), hot_only=False)
        if args.set:
            base.update(parse_overrides(args.set), hot_only=False)
        base.validate()
        self.cfg = base
        logcfg = getattr(base, "log", None)
        if isinstance(logcfg, LogConfig):
            setup_logging(logcfg, self.node_type)
        return base

    async def _fetch_template(self, mgmtd_address: str, *,
                              retries: int = 20, delay_s: float = 0.5) -> str:
        from t3fs_torch.mgmtd.service import GetConfigTemplateReq
        from t3fs_torch.net.client import Client

        cli = Client()
        try:
            for attempt in range(retries):
                try:
                    rsp, _ = await cli.call(
                        mgmtd_address, "Mgmtd.get_config_template",
                        GetConfigTemplateReq(self.node_type), timeout=5.0)
                    return rsp.toml if rsp.found else ""
                except Exception:
                    if attempt == retries - 1:
                        raise
                    await asyncio.sleep(delay_s)
            return ""
        finally:
            await cli.close()

    async def run(self, start, stop) -> None:
        """Start the server, then park until SIGTERM/SIGINT; stop cleanly."""
        loop = asyncio.get_running_loop()
        stopping = asyncio.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stopping.set)
        await start()
        log.info("%s up", self.node_type)
        await stopping.wait()
        log.info("%s stopping", self.node_type)
        await stop()
        self.stop_metrics()
