"""storage_main: storage node binary (reference: src/storage/storage.cpp,
TwoPhaseApplication<StorageServer>).

    python -m t3fs_torch.app.storage_main --config configs/storage1.toml
    python -m t3fs_torch.app.storage_main --fetch-config-from 127.0.0.1:9000 \
        --set node_id=2 --set data_dir='"/var/t3fs/n2"'

The port of t3fs/app/storage_main.py.  The node's payload CRCs run on its
checksum backend, the CUDA one by default ([service] checksum_backend), so
a process asked for "cuda" where no GPU is present fails at startup and
never falls back to the host CRC.  At stop it logs one line, CODEC_LOG_TAG
and a JSON object of its backend's counters (batches, batched_items and the
process's B1 launches): the one place a caller outside the process can read
them.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from dataclasses import dataclass

from t3fs_torch.app.base import ApplicationBase, LogConfig
from t3fs_torch.storage.server import StorageConfig, StorageServer
from t3fs_torch.utils.config import ConfigBase, citem, cobj

log = logging.getLogger("t3fs_torch.app")

CODEC_LOG_TAG = "checksum backend counters"


@dataclass
class StorageMainConfig(ConfigBase):
    node_id: int = citem(0, hot=False, validator=lambda v: v >= 0)
    mgmtd_address: str = citem("127.0.0.1:9000", hot=False)
    data_dir: str = citem("", hot=False)
    # target ids hosted by this node; chunk roots live at data_dir/t{id}
    target_ids: list[int] = citem(factory=list, hot=False)
    engine_backend: str = citem("native", hot=False)
    admin_token: str = citem("", hot=False)
    port_file: str = citem("", hot=False)
    monitor_address: str = citem("", hot=False)   # push metrics here
    metrics_period_s: float = citem(10.0, hot=False)
    service: StorageConfig = cobj(StorageConfig)
    log: LogConfig = cobj(LogConfig)


async def serve(cfg: StorageMainConfig, app: ApplicationBase) -> None:
    ss = StorageServer(
        cfg.node_id, cfg.mgmtd_address, cfg=cfg.service,
        admin_token=cfg.admin_token,
        default_root=cfg.data_dir,
        discover_targets=bool(cfg.data_dir))
    for tid in cfg.target_ids:
        root = os.path.join(cfg.data_dir or ".", f"t{tid}")
        ss.add_target(tid, root, engine_backend=cfg.engine_backend)

    async def start():
        await ss.start()
        app.start_metrics(cfg.monitor_address, cfg.node_id,
                          cfg.metrics_period_s)
        if cfg.port_file:
            # t3fslint: allow(blocking-in-async) — one-shot port-file write at startup
            with open(cfg.port_file, "w") as f:
                f.write(str(ss.server.port))

    async def stop():
        await ss.stop()
        from t3fs_torch.ops.cuda_codec import launches
        codec = ss.node.codec
        log.info("%s %s", CODEC_LOG_TAG, json.dumps({
            "node_id": cfg.node_id, "backend": codec.name,
            "batches": getattr(codec, "batches", 0),
            "batched_items": getattr(codec, "batched_items", 0),
            "crc_words_launches": launches["crc_words"]}))

    await app.run(start, stop)


def read_codec_counters(log_path: str) -> dict | None:
    """The last counters line a storage_main process logged at stop."""
    found = None
    with open(log_path) as f:
        for line in f:
            _, tag, rest = line.partition(CODEC_LOG_TAG + " ")
            if tag:
                found = json.loads(rest)
    return found


def main(argv: list[str] | None = None) -> None:
    app = ApplicationBase("storage", StorageMainConfig)
    cfg = app.boot(argv)
    asyncio.run(serve(cfg, app))


if __name__ == "__main__":
    main()
