"""MgmtdClient: routing-info cache + heartbeat loop.

Reference analogs: client/mgmtd/MgmtdClient.h — background-refreshed
RoutingInfo cache with role-split interfaces (ForClient refreshes routing;
ForServer additionally registers and heartbeats with local target states).

The port of t3fs/client/mgmtd_client.py.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable

from t3fs_torch.mgmtd.service import (
    ClientSessionReq, GetRoutingInfoReq, HeartbeatReq,
)
from t3fs_torch.mgmtd.types import (
    ClientSession, LocalTargetState, NodeInfo, RoutingInfo,
)
from t3fs_torch.net.client import Client
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.status import StatusError

log = logging.getLogger("t3fs_torch.client.mgmtd")


class MgmtdClient:
    """ForClient role: keeps a fresh RoutingInfo cache."""

    def __init__(self, mgmtd_address: str, client: Client | None = None,
                 refresh_period_s: float = 0.5, client_id: str = "",
                 description: str = "", seed_read_priors: bool = True,
                 incremental: bool = True):
        self.mgmtd_address = mgmtd_address
        self.client = client or Client()
        self.refresh_period_s = refresh_period_s
        # ask mgmtd for RoutingDelta instead of the full map on
        # every version bump — under rebalance churn each refresh then
        # carries only the chains that actually moved.  Counters are the
        # observability/test surface.
        self.incremental = incremental
        self.delta_refreshes = 0
        self.full_refreshes = 0
        # seed process-wide ReadStats priors from the scorecard
        # mgmtd piggybacks on GetRoutingInfoRsp, so a COLD client's
        # adaptive read selection and hedge clamps avoid known-slow nodes
        # on the very first read; live local samples override the prior
        self.seed_read_priors = seed_read_priors
        # non-empty client_id opts into mgmtd client-session tracking
        # (fbs/mgmtd/ClientSession.h); extended on its own cadence, NOT per
        # refresh tick — a KV write per 0.5s per client to maintain a 60s
        # TTL would be ~40x the needed write load
        self.client_id = client_id
        self.description = description
        self.session_extend_period_s = 20.0
        self._last_extend_sent = 0.0
        self._routing = RoutingInfo(version=0)
        self.health = None              # latest ClusterHealth piggyback
        self._health_version = 0
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    def routing(self) -> RoutingInfo:
        return self._routing

    async def extend_session(self) -> None:
        if not self.client_id:
            return
        now = time.time()
        if now - self._last_extend_sent < self.session_extend_period_s:
            return
        self._last_extend_sent = now
        try:
            await self.client.call(
                self.mgmtd_address, "Mgmtd.extend_client_session",
                ClientSessionReq(session=ClientSession(
                    client_id=self.client_id,
                    universal_id=self.client_id,
                    description=self.description)),
                timeout=5.0)
        except StatusError as e:
            log.warning("client session extend failed: %s", e)

    async def refresh(self) -> RoutingInfo:
        try:
            rsp, _ = await self.client.call(
                self.mgmtd_address, "Mgmtd.get_routing_info",
                GetRoutingInfoReq(known_version=self._routing.version,
                                  known_health_version=self._health_version,
                                  want_delta=self.incremental
                                  and self._routing.version > 0),
                timeout=5.0)
            delta = getattr(rsp, "delta", None)
            if rsp.info is not None:
                self._routing = rsp.info
                self.full_refreshes += 1
            elif delta is not None:
                self._apply_delta(delta)
            # getattr: a pre-scorecard mgmtd's rsp has no health fields
            health = getattr(rsp, "health", None)
            if health is not None:
                self.health = health
                self._health_version = getattr(rsp, "health_version", 0)
                if self.seed_read_priors:
                    self._seed_read_priors(health)
        except StatusError as e:
            log.warning("routing refresh failed: %s", e)
        return self._routing

    def _apply_delta(self, delta) -> None:
        """Merge a RoutingDelta into the cached map.  Copy-on-write: the
        new RoutingInfo shares every unchanged ChainInfo object with the
        old one, so concurrent readers holding the old reference see a
        consistent snapshot.  A base-version mismatch (a raced refresh)
        is dropped — the next tick's known_version resolves it."""
        cur = self._routing
        if delta.base_version != cur.version:
            log.warning("routing delta base %d != cached %d; dropped",
                        delta.base_version, cur.version)
            return
        chains = dict(cur.chains)
        for c in delta.chains:
            chains[c.chain_id] = c
        for cid in delta.removed_chains:
            chains.pop(cid, None)
        self._routing = RoutingInfo(
            version=delta.version, bootstrapping=delta.bootstrapping,
            nodes=delta.nodes, chains=chains,
            chain_tables=delta.chain_tables)
        self.delta_refreshes += 1

    def _seed_read_priors(self, health) -> None:
        """Push scorecard latency hints into the process-wide ReadStats
        as priors.  seed_prior only takes on addresses with NO live
        samples yet, so a warm client's own measurements always win;
        unknown/stale nodes are skipped — an absent prior (optimistic
        cold-start) beats a wrong one."""
        from t3fs_torch.net.rpcstats import READ_STATS
        for nh in health.nodes:
            if nh.stale or not nh.count:
                continue
            cls = {}
            for cls_id, p9x_ms in (nh.cls_p9x_ms or {}).items():
                try:
                    cls[int(cls_id)] = float(p9x_ms) / 1e3
                except (TypeError, ValueError):
                    continue
            READ_STATS.seed_prior(nh.addr, p50_s=nh.read_p50_s,
                                  p9x_s=nh.read_p99_s, cls_p9x_s=cls)

    async def start(self) -> None:
        await self.refresh()
        self._task = asyncio.create_task(self._loop(), name="mgmtd-refresh")

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.refresh_period_s)
            await self.refresh()
            await self.extend_session()

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "mgmtd refresh loop")
        await self.client.close()


class MgmtdClientForServer(MgmtdClient):
    """ForServer role: + registration & heartbeat loop carrying local target
    states (the failure-detection input, SURVEY.md §3.5)."""

    def __init__(self, mgmtd_address: str, node: NodeInfo,
                 target_states: Callable[[], dict[int, LocalTargetState]],
                 client: Client | None = None,
                 heartbeat_period_s: float = 0.3,
                 refresh_period_s: float = 0.5,
                 default_lease_s: float = 2.0,
                 fresh_targets: Callable[[], list[int]] | None = None):
        super().__init__(mgmtd_address, client, refresh_period_s)
        self.node = node
        self.target_states = target_states
        self.fresh_targets = fresh_targets or (lambda: [])
        self.heartbeat_period_s = heartbeat_period_s
        self._hb_task: asyncio.Task | None = None
        self.last_heartbeat_ok: float = 0.0
        # self-fencing state (reference: suicide.cc kills the process when
        # mgmtd is unreachable for lease/2; t3fs demotes instead of dying):
        # lease_s comes from mgmtd's heartbeat response, the monotonic
        # stamp survives wall-clock jumps.  default_lease_s covers the
        # restart-while-partitioned window: a node that has NEVER
        # completed a heartbeat must still fence, or a head that crashes
        # and restarts during a partition keeps acking on stale routing
        # (defaults match mgmtd's heartbeat_timeout_s default of 2.0).
        self.lease_s: float = 0.0
        self.default_lease_s = default_lease_s
        self._last_hb_mono: float = time.monotonic()

    def fenced(self) -> bool:
        """True when this node must stop serving writes: no successful
        heartbeat for lease/2, so mgmtd may be about to (or already did)
        hand our chain roles to someone else.  A node that keeps acking
        in this state can lose acknowledged data — the chain_ver check
        alone only protects clients with FRESH routing."""
        lease = self.lease_s or self.default_lease_s
        return (lease > 0
                and time.monotonic() - self._last_hb_mono > lease / 2)

    async def heartbeat_once(self) -> bool:
        try:
            rsp, _ = await self.client.call(
                self.mgmtd_address, "Mgmtd.heartbeat",
                HeartbeatReq(node=self.node, target_states=self.target_states(),
                             routing_version=self._routing.version,
                             fresh_targets=self.fresh_targets()),
                timeout=5.0)
            self.last_heartbeat_ok = time.time()
            self._last_hb_mono = time.monotonic()
            if getattr(rsp, "lease_s", 0.0):
                self.lease_s = rsp.lease_s
            if rsp.routing_version > self._routing.version:
                await self.refresh()
            return True
        except StatusError as e:
            log.warning("heartbeat failed: %s", e)
            return False

    async def start(self) -> None:
        await self.heartbeat_once()
        await super().start()
        self._hb_task = asyncio.create_task(self._hb_loop(), name="mgmtd-hb")

    async def _hb_loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.heartbeat_period_s)
            await self.heartbeat_once()

    async def stop(self) -> None:
        if self._hb_task:
            self._hb_task.cancel()
            await reap_task(self._hb_task, log, "mgmtd heartbeat loop")
        await super().stop()
