"""kv_main: replicated transactional KV service binary.

The FoundationDB role (reference fdb/HybridKvEngine.h) as a t3fs service:
meta and mgmtd point their `kv = "remote:primary:port,follower:port"` spec
at a deployment of these.  One node runs role=primary with the follower
list; followers run role=follower and are promoted via Kv.promote on
failover.

    python -m t3fs_torch.app.kv_main --set listen_port=9400 --set role=primary \
        --set followers=127.0.0.1:9401 --set kv=wal:/data/kv1

The port of t3fs/app/kv_main.py.  It runs no device work; DevCluster
spawns it with no GPU visible.
"""

from __future__ import annotations

import asyncio
import json
import logging
from dataclasses import dataclass

from t3fs_torch.app.base import ApplicationBase, LogConfig
from t3fs_torch.kv.service import KvService
from t3fs_torch.kv.wal_engine import open_kv_engine
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.utils.config import ConfigBase, citem, cobj

log = logging.getLogger("t3fs_torch.app")

# the tag of the line a primary logs once recover_prepared has run: its
# JSON says how many durable prepared cross-shard txns it re-armed and how
# many of those it resolved before listening
RECOVER_LOG_TAG = "kv recover_prepared"


@dataclass
class KvMainConfig(ConfigBase):
    node_id: int = citem(0, hot=False)
    listen_host: str = citem("127.0.0.1", hot=False)
    listen_port: int = citem(0, hot=False)
    role: str = citem("primary", hot=False,
                      validator=lambda v: v in ("primary", "follower"))
    followers: str = citem("", hot=False)   # comma-separated addresses
    kv: str = citem("mem", hot=False)
    port_file: str = citem("", hot=False)
    # compress RPC frames >= this size (0 = off; UseCompress analog)
    compress_threshold: int = citem(0, hot=False)
    monitor_address: str = citem("", hot=False)   # push metrics here
    metrics_period_s: float = citem(10.0, hot=False)
    # tag for this node's kv.range.{reads,writes,bytes} gauges (the
    # monitor distinguishes groups by it; "" keeps the bare names)
    stats_group: str = citem("", hot=False)
    log: LogConfig = cobj(LogConfig)


async def resolve_decided(svc: KvService) -> int:
    """Finish, before the node listens, every re-armed participant txn
    whose decider has already decided; returns how many.  The reference
    leaves them to their resolution timers (0.5 s after recover_prepared),
    and in that window a txn acknowledged on the decider's COMMIT record
    (meta's idempotent retry after TXN_MAYBE_COMMITTED) reads as absent
    here: a create acknowledged, then a stat answering META_NOT_FOUND.
    A txn this node decides, or whose decider is unreachable or still
    undecided, stays with its timer, as in the reference."""
    done = 0
    for txn_id, (_txn, _timer, req) in list(svc._prepared.items()):
        if req.is_decider:
            continue
        try:
            done += await svc._resolve_once(txn_id)
        except Exception as e:      # the timer retries it
            log.warning("2pc %s: not resolved at start: %s", txn_id, e)
    return done


async def serve(cfg: KvMainConfig, app: ApplicationBase) -> None:
    engine = open_kv_engine(cfg.kv)
    rpc = Server(cfg.listen_host, cfg.listen_port,
                 compress_threshold=cfg.compress_threshold)
    # replication pushes to followers are the node's biggest frames —
    # the compression knob must cover them, not just responses
    client = Client(compress_threshold=cfg.compress_threshold)
    svc = KvService(engine, primary=(cfg.role == "primary"),
                    followers=[a for a in cfg.followers.split(",") if a],
                    client=client)
    svc.export_load_gauges(group=cfg.stats_group)
    rpc.add_service(svc)

    async def start():
        if cfg.role == "primary":
            # finish any cross-shard txn this node crashed mid-2PC on
            # (durable prepare records; see kv/shard.py); a follower
            # gets both via Kv.promote
            n = await svc.recover_prepared()
            resolved = await resolve_decided(svc)
            log.info("%s %s", RECOVER_LOG_TAG,
                     json.dumps({"recovered": n, "resolved": resolved}))
            svc.ensure_decision_gc()
        await rpc.start()
        app.start_metrics(cfg.monitor_address, cfg.node_id,
                          cfg.metrics_period_s)
        if cfg.port_file:
            # t3fslint: allow(blocking-in-async) — one-shot port-file write at startup
            with open(cfg.port_file, "w") as f:
                f.write(str(rpc.port))

    async def stop():
        svc.stop_decision_gc()
        await rpc.stop()
        await client.close()
        if hasattr(engine, "close"):
            engine.close()

    await app.run(start, stop)


def read_recovered(log_path: str) -> list[dict]:
    """Every recovery line a kv_main primary logged, in order (one a start
    over this log): {"recovered": re-armed txns, "resolved": of those,
    resolved before it listened}."""
    found = []
    with open(log_path) as f:
        for line in f:
            _, tag, rest = line.partition(RECOVER_LOG_TAG + " ")
            if tag:
                found.append(json.loads(rest))
    return found


def main(argv: list[str] | None = None) -> None:
    app = ApplicationBase("kv", KvMainConfig)
    cfg = app.boot(argv)
    asyncio.run(serve(cfg, app))


if __name__ == "__main__":
    main()
