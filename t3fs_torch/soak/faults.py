"""The live fault schedule: WHAT breaks WHEN, decided up front.

The schedule is deterministic given the spec's seed — node picks come
from a dedicated RNG stream, timing from an injectable clock/sleep pair
— so a soak run is reproducible and the unit test can replay the whole
schedule in microseconds against a fake clock and assert the same
(time, kind, node) sequence twice.

The schedule does not touch the cluster itself; it drives an *injector*
with one method per fault kind.  The runner supplies `LiveInjector`
(LocalCluster fault hooks + scrub-registry bit-rot picks); tests supply
a recorder.  Faults the injector raises on (e.g. a crash pick racing a
node already down) are recorded as failed and the schedule moves on —
one bad injection must not cancel the rest of the scenario.
"""

from __future__ import annotations

import asyncio
import logging
import re
import time
from dataclasses import dataclass, field

import numpy as np

from t3fs_torch.soak.spec import SoakSpec

log = logging.getLogger("t3fs_torch.soak")


@dataclass
class FaultEvent:
    """One injection as it actually happened (the run's fault log)."""
    t: float                 # seconds since schedule start
    kind: str                # straggler | straggler-clear | crash | bitrot
    node: int
    ok: bool = True
    detail: str = ""


class LiveInjector:
    """Faults against a real LocalCluster + ScrubScheduler."""

    def __init__(self, cluster, scrub=None, rng=None, on_restart=None):
        self.cluster = cluster
        self.scrub = scrub
        self.rng = rng or np.random.default_rng(0)
        # async callable(node_id) run after a crash-restart: the fresh
        # StorageServer has a fresh CheckWorker, so the runner rewires
        # its corrupt_sink here
        self.on_restart = on_restart

    async def straggler(self, node: int, delay_s: float) -> str:
        self.cluster.set_read_delay(node, delay_s)
        return f"read_delay_s={delay_s}"

    async def straggler_clear(self, node: int) -> str:
        self.cluster.set_read_delay(node, 0.0)
        return ""

    async def crash(self, node: int) -> str:
        # kill + wait for chain failover + wipe disk + restart empty:
        # the repair path (scrub full-stripe rebuild, CRAQ resync) is
        # what brings the node's data back while traffic continues
        await self.cluster.restart_storage_node_empty(node)
        if self.on_restart is not None:
            await self.on_restart(node)
        return "restarted empty"

    async def node_add(self, node: int) -> str:
        """Elastic membership: bring up a brand-new EMPTY
        storage node mid-run.  With the rebalancer on, the next plan tick
        starts moving chains onto it under live traffic; without it the
        node just idles (still a valid scenario: registration churn)."""
        ss = await self.cluster.add_storage_node(node)
        if self.on_restart is not None:
            await self.on_restart(ss.node_id)
        return f"node {ss.node_id} up (empty)"

    async def node_drain(self, node: int) -> str:
        """Graceful drain: tag the node ``drain``.  It keeps serving
        (disable-node would demote its targets immediately and strand
        single-replica EC chains without a resync source) while the
        rebalancer's solver stops assigning it chains and migrates its
        holdings elsewhere, move by paced move."""
        from t3fs_torch.mgmtd.service import NodeOpReq
        cur = self.cluster.mgmtd.state.routing().nodes.get(node)
        tags = list(cur.tags) if cur is not None else []
        if "drain" not in tags:
            tags.append("drain")
        await self.cluster.admin.call(
            self.cluster.mgmtd_rpc.address, "Mgmtd.set_node_tags",
            NodeOpReq(node_id=node, tags=tags))
        return "tagged drain (rebalancer migrates its chains off)"

    async def bitrot(self, node: int, chunks: int) -> str:
        """Flip bytes in `chunks` live EC shards picked from the scrub
        registry (auto-discovered from checkpoint manifests — nothing
        here is manually registered).  CheckWorker's verified reads or
        the next scrub probe notice; repair heals.

        Picks go stale under live traffic — checkpoint GC deletes steps,
        a crash fault wipes a node's disk, a chain can be headless
        mid-failover — so refresh the registry, pick from the newest
        step (longest remaining lifetime under keep-last-N GC), and
        oversample past dead picks rather than fail on the first one."""
        rotted, stale = 0, 0
        refresh = getattr(self.scrub, "refresh_targets", None)
        for attempt in range(4):
            if refresh is not None:
                try:
                    await refresh()
                except Exception:                # noqa: BLE001
                    pass                         # keep the old registry
            for chain_id, chunk_id in self._pick_shards(chunks - rotted):
                try:
                    hit = self.cluster.corrupt_chunk_on_disk(
                        chain_id, chunk_id)
                except Exception:                # noqa: BLE001
                    hit = False                  # headless chain / dead node
                if hit:
                    rotted += 1
                else:
                    stale += 1
            if rotted >= chunks:
                break
        if not rotted:
            raise RuntimeError(
                f"no live EC shard to rot ({stale} stale picks)")
        return f"{rotted} shards" + (f" ({stale} stale picks)" if stale
                                     else "")

    @staticmethod
    def _recency(name: str) -> int:
        m = re.search(r"/step-(\d+)/", name)
        return int(m.group(1)) if m else -1

    def _pick_shards(self, n: int) -> list[tuple[int, object]]:
        if self.scrub is None:
            return []
        out: list[tuple[int, object]] = []
        targets = [t for t in self.scrub._targets.values() if t.stripe_lens]
        if not targets:
            return []
        # checkpoint GC churns steps far faster than a scrub period:
        # under keep-last-N only the NEWEST step has meaningful remaining
        # lifetime, so restrict picks to it
        newest = max(self._recency(t.name) for t in targets)
        targets = [t for t in targets if self._recency(t.name) == newest]
        for _ in range(n):
            t = targets[int(self.rng.integers(0, len(targets)))]
            lay = t.layout
            written = [s for s, ln in t.stripe_lens.items() if ln > 0]
            if not written:
                continue
            stripe = written[int(self.rng.integers(0, len(written)))]
            # data shards only: shard s covers bytes [s*cs, (s+1)*cs) of
            # the stripe — pick one that actually holds bytes
            live = [s for s in range(lay.k)
                    if min(lay.chunk_size,
                           t.stripe_lens[stripe] - s * lay.chunk_size) > 0]
            if not live:
                continue
            s = live[int(self.rng.integers(0, len(live)))]
            out.append((lay.shard_chain(stripe, s),
                        lay.shard_chunk(t.inode, stripe, s)))
        return out


class FaultSchedule:
    """Replays `spec.faults` (already sorted by at_s) against an
    injector, on an injectable clock."""

    def __init__(self, spec: SoakSpec, injector,
                 clock=None, sleep=None):
        self.spec = spec
        self.injector = injector
        self.clock = clock or time.monotonic
        self.sleep = sleep or asyncio.sleep
        # dedicated stream: adding a workload must not reshuffle which
        # node a fault hits
        self.rng = np.random.default_rng(spec.seed ^ 0xFA017)
        self.events: list[FaultEvent] = []
        self._clears: list[asyncio.Task] = []
        self._t0 = 0.0

    def _now(self) -> float:
        return self.clock() - self._t0

    def _pick_node(self, explicit: int) -> int:
        if explicit:
            return explicit
        return int(self.rng.integers(1, self.spec.nodes + 1))

    async def run(self) -> list[FaultEvent]:
        self._t0 = self.clock()
        for f in self.spec.faults:
            delay = f.at_s - self._now()
            if delay > 0:
                await self.sleep(delay)
            # node_add with no explicit node: 0 = "pick a fresh id"
            # (the injector allocates max+1); the seeded picker must not
            # hand it an EXISTING node
            node = 0 if (f.kind == "node_add" and not f.node) \
                else self._pick_node(f.node)
            ev = FaultEvent(self._now(), f.kind, node)
            try:
                if f.kind == "straggler":
                    ev.detail = await self.injector.straggler(
                        node, f.delay_ms / 1000.0)
                    self._clears.append(asyncio.create_task(
                        self._clear_later(node, f.duration_s),
                        name=f"soak-fault-clear-n{node}"))
                elif f.kind == "crash":
                    ev.detail = await self.injector.crash(node)
                elif f.kind == "bitrot":
                    ev.detail = await self.injector.bitrot(node, f.chunks)
                elif f.kind == "node_add":
                    ev.detail = await self.injector.node_add(node)
                elif f.kind == "node_drain":
                    ev.detail = await self.injector.node_drain(node)
            except Exception as e:               # noqa: BLE001
                ev.ok = False
                ev.detail = f"{type(e).__name__}: {e}"
                log.warning("soak fault %s@%.1fs on node %d failed: %s",
                            f.kind, ev.t, node, e)
            self.events.append(ev)
        if self._clears:
            await asyncio.gather(*self._clears, return_exceptions=True)
        return self.events

    async def _clear_later(self, node: int, duration_s: float) -> None:
        await self.sleep(duration_s)
        ev = FaultEvent(self._now(), "straggler-clear", node)
        try:
            await self.injector.straggler_clear(node)
        except Exception as e:                   # noqa: BLE001
            ev.ok = False
            ev.detail = f"{type(e).__name__}: {e}"
        self.events.append(ev)
