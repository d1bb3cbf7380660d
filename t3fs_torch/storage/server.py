"""StorageServer: one storage node process wired to mgmtd.

Reference analog: storage/service/StorageServer + Components wiring +
TwoPhaseApplication<StorageServer> bootstrap (storage.cpp): the node hosts
the Storage RPC service, heartbeats to mgmtd with local target states, and
runs the resync worker.

The port of t3fs/storage/server.py.  One deliberate difference: the
checksum backend defaults to "cuda" (B1 on the card for every payload at
or above its device cutoff), as StorageNode's does; the reference's
default is "cpu".
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
import time as _time

from dataclasses import dataclass

from t3fs_torch.client.mgmtd_client import MgmtdClientForServer
from t3fs_torch.mgmtd.types import NodeInfo, PublicTargetState
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.storage.resync import ResyncWorker
from t3fs_torch.storage.codec_backend import make_checksum_backend
from t3fs_torch.storage.service import StorageNode, StorageService
from t3fs_torch.utils.config import ConfigBase, citem, cobj
from t3fs_torch.utils.tracing import TraceConfig, configure as configure_tracing

log = logging.getLogger("t3fs_torch.storage")

CHECKSUM_BACKENDS = ("cuda", "gpu", "device", "tpu", "cpu", "null")


@dataclass
class StorageConfig(ConfigBase):
    """Storage node knobs.  Periods are hot (loops read them live);
    listen address is not (requires restart)."""
    host: str = citem("127.0.0.1", hot=False)
    port: int = citem(0, hot=False)
    heartbeat_period_s: float = citem(0.3, validator=lambda v: v > 0)
    resync_period_s: float = citem(0.2, validator=lambda v: v > 0)
    disk_check_period_s: float = citem(5.0, validator=lambda v: v > 0)
    maintenance_period_s: float = citem(30.0, validator=lambda v: v > 0)
    # the codec seam (north star): cuda | cpu | null; "gpu", "device" and
    # "tpu" (the value existing deployments carry) name the CUDA backend,
    # as make_checksum_backend maps them
    checksum_backend: str = citem(
        "cuda", hot=False, validator=lambda v: v in CHECKSUM_BACKENDS)
    # io_uring read pipeline (AioReadWorker analog); auto-disables when the
    # kernel lacks io_uring
    aio_read: bool = citem(True, hot=False)
    # pipelined CRAQ writes (docs/design_notes.md §3): off = serialize
    # apply -> CRC -> forward (legacy behavior, byte-identical); overlap =
    # forward concurrently with local CRC+apply; streamed = overlap +
    # cut-through UPDATE_FRAG fragment forwarding
    write_pipeline: str = citem(
        "off", validator=lambda v: v in ("off", "overlap", "streamed"))
    # payloads at/above this stream as fragments (write_pipeline=streamed)
    stream_threshold: int = citem(512 << 10, validator=lambda v: v > 0)
    stream_frag_bytes: int = citem(256 << 10, validator=lambda v: v > 0)
    # unacknowledged in-flight fragments per stream (every window-th frame
    # is a call() whose response is the cumulative ack)
    stream_window: int = citem(4, validator=lambda v: v > 0)
    # distributed tracing (t3fs_torch/utils/tracing.py): sampling + buffer knobs;
    # installed process-wide on start and on every hot update
    trace: TraceConfig = cobj(TraceConfig)


class StorageServer:
    def __init__(self, node_id: int, mgmtd_address: str, *,
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_period_s: float = 0.3,
                 resync_period_s: float = 0.2,
                 checksum_backend="cuda",
                 write_pipeline: str = "off",
                 cfg: StorageConfig | None = None,
                 admin_token: str = "",
                 default_root: str = "",
                 discover_targets: bool = False):
        # a backend instance or factory (a CudaChecksumBackend on
        # device="cpu" in the tests) goes to the node as it is; the config
        # records its name
        backend = None
        if checksum_backend is not None \
                and not isinstance(checksum_backend, str):
            backend = make_checksum_backend(checksum_backend)
            checksum_backend = backend.name
        self.cfg = cfg or StorageConfig(
            host=host, port=port, heartbeat_period_s=heartbeat_period_s,
            resync_period_s=resync_period_s, checksum_backend=checksum_backend,
            write_pipeline=write_pipeline)
        self.node_id = node_id
        self.server = Server(self.cfg.host, self.cfg.port)
        self.node = StorageNode(node_id, self._routing, Client(),
                                checksum_backend=backend
                                or self.cfg.checksum_backend,
                                write_pipeline=self.cfg.write_pipeline)
        self.node.stream_threshold = self.cfg.stream_threshold
        self.node.stream_frag_bytes = self.cfg.stream_frag_bytes
        self.node.stream_window = self.cfg.stream_window
        # default_root lets a remote caller (the rebalancer)
        # create_target without knowing this node's disk layout; discovery
        # re-adds t{id} dirs after a restart so migrated-in targets survive
        # a crash of their new home
        self.node.default_root = default_root
        self.discover_targets = discover_targets
        self.service = StorageService(self.node)
        self.server.add_service(self.service)
        from t3fs_torch.core.service import AppInfo, CoreService
        self.core = CoreService(AppInfo(node_id, "storage"), config=self.cfg,
                                admin_token=admin_token)
        self.server.add_service(self.core)
        from t3fs_torch.storage.check_worker import CheckWorker, MaintenanceWorker

        self.mgmtd_address = mgmtd_address
        self.heartbeat_period_s = self.cfg.heartbeat_period_s
        self.resync = ResyncWorker(self.node, period_s=self.cfg.resync_period_s)
        self.check = CheckWorker(self.node,
                                 period_s=self.cfg.disk_check_period_s)
        self.maintenance = MaintenanceWorker(
            self.node, period_s=self.cfg.maintenance_period_s)
        self.mgmtd: MgmtdClientForServer | None = None

    def _routing(self):
        return self.mgmtd.routing() if self.mgmtd else None

    def add_target(self, target_id: int, root: str, **kw):
        return self.node.add_target(target_id, root, **kw)

    def _fresh_targets(self) -> list[int]:
        """Heartbeat provider: targets still on a virgin disk.  A target
        the ROUTING seats as SERVING holds the chain's lineage — clients
        write to it — so freshness ends there (the state machine only
        seats a fresh target when its emptiness IS the lineage: cold
        start / orphan promotion).  Without this, a seed target that
        never resyncs reports fresh forever and a later fresh-LASTSRV
        demotion would discard its real data.

        LASTSRV must NOT end freshness: a wiped target's
        LASTSRV seat always predates the wipe — mgmtd never seats a
        known-fresh target as LASTSRV — so a routing view still showing
        LASTSRV is stale history, not lineage.  Clearing on it raced
        mgmtd's chains tick: the second heartbeat dropped the fresh flag
        before the demotion ran, the reseat branch made the empty disk
        SERVING, and resync erased survivors (the seed-2802880 acked-
        write loss).  craq_sim clears disk_fresh only on a SERVING seat
        or sync_done; this now matches the protocol the sweeps verified."""
        routing = self.node.routing()
        serving_roles = set()
        for chain in routing.chains.values():
            for t in chain.targets:
                if t.public_state == PublicTargetState.SERVING:
                    serving_roles.add(t.target_id)
        out = []
        for tid, t in self.node.targets.items():
            if t.booted_fresh and tid in serving_roles:
                t.booted_fresh = False
            elif t.booted_fresh:
                out.append(tid)
        return out

    def _on_config_updated(self, keys: list[str]) -> None:
        """Push hot values into running components (onConfigUpdated analog)."""
        self.heartbeat_period_s = self.cfg.heartbeat_period_s
        if self.mgmtd is not None:
            self.mgmtd.heartbeat_period_s = self.cfg.heartbeat_period_s
            self.mgmtd.refresh_period_s = self.cfg.heartbeat_period_s
        self.resync.period_s = self.cfg.resync_period_s
        self.node.write_pipeline = self.cfg.write_pipeline
        self.node.stream_threshold = self.cfg.stream_threshold
        self.node.stream_frag_bytes = self.cfg.stream_frag_bytes
        self.node.stream_window = self.cfg.stream_window
        configure_tracing(self.cfg.trace)

    def _discover_targets(self) -> list[int]:
        """Re-adopt t{target_id} chunk dirs under default_root that nobody
        add_target()ed this boot — a target migrated onto this node by the
        rebalancer has no config entry, so without this a restart would
        silently drop it (routing says SERVING here, heartbeats say no
        such target, mgmtd degrades the chain)."""
        found = []
        if not (self.discover_targets and self.node.default_root
                and os.path.isdir(self.node.default_root)):
            return found
        for name in sorted(os.listdir(self.node.default_root)):
            m = re.fullmatch(r"t(\d+)", name)
            if not m:
                continue
            tid = int(m.group(1))
            path = os.path.join(self.node.default_root, name)
            if tid in self.node.targets or not os.path.isdir(path):
                continue
            self.node.add_target(tid, path)
            found.append(tid)
        if found:
            log.info("node %d re-adopted targets %s from %s", self.node_id,
                     found, self.node.default_root)
        return found

    async def start(self) -> None:
        configure_tracing(self.cfg.trace)
        # before the first heartbeat: local_states must cover adopted
        # targets or mgmtd briefly sees them missing
        self._discover_targets()
        if self.cfg.aio_read:
            from t3fs_torch.storage.aio import AioReadWorker
            if AioReadWorker.available():
                self.node.aio = AioReadWorker()
                self.node.aio.start()
            else:
                log.info("io_uring unavailable; thread-pool reads")
        await self.server.start()
        self.core.app_info.address = self.server.address
        self.core.on_config_updated = self._on_config_updated
        self.mgmtd = MgmtdClientForServer(
            self.mgmtd_address,
            NodeInfo(self.node_id, self.server.address, "storage",
                     generation=_time.time()),
            lambda: dict(self.node.local_states),
            heartbeat_period_s=self.heartbeat_period_s,
            refresh_period_s=self.heartbeat_period_s,
            fresh_targets=self._fresh_targets)
        await self.mgmtd.start()
        # self-fencing: refuse writes once the mgmtd lease (reported in
        # heartbeat responses) has lapsed for lease/2 — see suicide.cc
        self.node.fence = self.mgmtd.fenced
        await self.resync.start()
        await self.check.start()
        await self.maintenance.start()
        if hasattr(self.node.codec, "warmup"):
            # load the kernel library and build the common chunk-size
            # buckets' tables in the background, so the first write doesn't
            # eat the build on the hot path
            self._warmup_task = asyncio.get_running_loop().run_in_executor(
                None, self.node.codec.warmup,
                [64 << 10, 512 << 10, 1 << 20, 4 << 20])
        log.info("storage node %d up at %s", self.node_id, self.server.address)

    async def stop(self) -> None:
        # best-effort through EVERY stage: a failure in one (e.g. an mgmtd
        # goodbye racing a dead conn) must not leave the listener bound or
        # the engines open — callers rely on stop() releasing the dirs even
        # when it raises.  First error re-raised at the end.  The one
        # exception is server.stop() itself failing: handler tasks may
        # still hold the aio ring/engines, so those are leaked (never
        # closed under in-flight reads) and the node is treated as wedged.
        first: Exception | None = None

        async def _stage(coro) -> None:
            # Exception only: a CancelledError mid-stage must propagate
            # immediately (it is the caller breaking a hung shutdown)
            nonlocal first
            try:
                await coro
            except Exception as e:
                first = first or e

        await _stage(self.maintenance.stop())
        await _stage(self.check.stop())
        await _stage(self.resync.stop())
        if self.mgmtd:
            await _stage(self.mgmtd.stop())
        await _stage(self.node.client.close())
        await _stage(self.node.codec.close())
        try:
            await self.server.stop()
        except Exception as e:
            # handler tasks may still be running with batch_reads holding
            # node.aio / the engines: closing either under them is a
            # use-after-free, so leak them rather than crash — the first
            # error propagates (chained so the leak's trigger is recorded)
            # and the caller treats the node as wedged
            raise (first or e) from e
        # only after the RPC server stops: in-flight batch_reads may hold
        # node.aio, and closing the ring under them is a use-after-free
        if self.node.aio is not None:
            await _stage(self.node.aio.close())
            self.node.aio = None
        for t in self.node.targets.values():
            # close() joins the update worker — never on the event loop
            await _stage(asyncio.to_thread(t.close))
        if first is not None:
            raise first
