"""ScrubScheduler: paced background scrub + repair for EC files.

Part of the repair-bandwidth work: a cluster-side
loop that WALKS registered EC files stripe by stripe, detects lost and
corrupt shards with cheap `no_payload + verify_checksum` probes (the
server CRCs its stored bytes; no payload crosses the wire), and drives
`RepairDriver` over what it finds — under the driver's token-bucket byte
budget (`storage.repair_budget_mbps`) so rebuild traffic never starves
foreground reads.

Classification follows the checkpoint scrubber precedent
(ckpt/reader.py::_scrub_stripe):

  * a hole shard (trimmed data slot, stripe_len says zero bytes) must be
    ABSENT — an OK probe on a hole is corruption (stale bytes a decode
    would trust);
  * CHECKSUM_MISMATCH is server-side bit rot -> corrupt;
  * any other non-OK probe is lost (absent or unreachable);
  * corrupt shards are REMOVEd before repair, because a corrupt shard is
    still READABLE and the repair read path would happily decode from
    the wrong bytes.

Crash/restart idempotence: the cursor is in-memory ONLY, and that is the
design, not a gap — a restarted scheduler rescans from stripe 0, finds
the already-repaired stripes healthy, and repairs nothing twice (repair
itself writes committed shards, so a crash mid-repair leaves either the
old hole or the full rebuilt shard; both rescan cleanly).

CheckWorker integration (the log-and-forget bugfix): storage nodes that
detect a corrupt chunk during their local verify pass push it through a
`corrupt_sink` callable; `note_corrupt` resolves the ChunkId back to
(file, stripe, slot) against the registered targets and queues that
stripe for the NEXT tick, so node-side detection actually triggers
repair instead of dying in a log line.

Health surfacing: `status()` is a plain dict of counters; the owner
(bench harness, admin tooling) forwards it to mgmtd via
`Mgmtd.report_repair_status`, and `admin repair-status` reads it back.

The port of t3fs/storage/scrub_scheduler.py over the port's ECStorageClient
and RepairDriver: repairs run on TorchECCodec's CUDA kernels.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from t3fs_torch.client.ec_client import (
    LOCAL_NS, PARITY_NS, ECLayout, ECStorageClient)
from t3fs_torch.client.repair import RepairDriver, RepairJob, RepairReport
from t3fs_torch.storage.types import ChunkId, ReadIO, UpdateType
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.status import StatusCode

log = logging.getLogger("t3fs_torch.storage.scrub")


@dataclass
class ScrubTarget:
    """One EC file under scrub: layout + inode + true per-stripe lengths
    (the stripe_len_of map RepairJob wants; stripes absent from the map
    were never written and are skipped)."""
    name: str
    layout: ECLayout
    inode: int
    stripe_lens: dict[int, int]

    @property
    def num_stripes(self) -> int:
        return (max(self.stripe_lens) + 1) if self.stripe_lens else 0


@dataclass
class ScrubStats:
    """Cumulative counters across ticks (status() snapshot source)."""
    ticks: int = 0
    stripes_scanned: int = 0
    shards_probed: int = 0
    shards_lost: int = 0
    shards_corrupt: int = 0
    flagged_enqueued: int = 0      # CheckWorker corrupt_sink arrivals
    flagged_unresolved: int = 0    # sink chunks matching no registered file
    discovery_errors: int = 0      # failed refresh_targets pulls (kept old set)
    repaired_stripes: int = 0
    repaired_shards: int = 0
    stripes_failed: int = 0
    # probed stripes with EVERY slot absent: the file was deleted between
    # discovery refresh and probe (ckpt GC racing a live scan) — skipped,
    # not failed
    stripes_vanished: int = 0
    bytes_read: int = 0
    bytes_repaired: int = 0
    reduced_shards: int = 0
    fallback_shards: int = 0
    paced_waits: int = 0
    paced_wait_s: float = 0.0


class ScrubScheduler:
    """Walks registered EC files, classifies shard damage, repairs it
    through a (possibly paced) RepairDriver, and keeps health counters.

    `stripes_per_tick` bounds probe fan-out per tick; the byte budget
    bounds repair fabric traffic.  Both are deliberately separate knobs:
    probes are no-payload (cheap on the wire, a CRC pass on the server),
    repairs move real survivor bytes."""

    def __init__(self, ec: ECStorageClient, *,
                 repair_mode: str = "subshard",
                 budget_mbps: float = 0.0,
                 budget_burst_bytes: int | None = None,
                 concurrency: int = 4,
                 stripes_per_tick: int = 64,
                 period_s: float = 30.0,
                 report_cb=None,
                 discovery=None):
        self.ec = ec
        self.driver = RepairDriver(
            ec, concurrency=concurrency, repair_mode=repair_mode,
            budget_mbps=budget_mbps, budget_burst_bytes=budget_burst_bytes)
        self.stripes_per_tick = stripes_per_tick
        self.period_s = period_s
        self.report_cb = report_cb          # async callable(status_dict)
        # async callable() -> iterable[ScrubTarget]: targets auto-derived
        # from metadata (e.g. ckpt/scrub.py walks committed manifests) so
        # new files enter scrub without per-file registration.  Manual
        # add_target entries coexist; only discovery-sourced names are
        # dropped when discovery stops returning them.
        self.discovery = discovery
        self._discovered: set[str] = set()
        # corrupt_sink chunks that matched no target YET: with discovery
        # on, a CheckWorker can flag bit-rot in a checkpoint committed
        # after our last refresh — retried (bounded) at the next refresh
        # instead of dropped
        self._unresolved: list[ChunkId] = []
        self.stats = ScrubStats()
        self._targets: dict[str, ScrubTarget] = {}
        # stripes the corrupt_sink flagged for priority rescan next tick
        self._flagged: set[tuple[str, int]] = set()
        self._cursor: dict[str, int] = {}
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    # -- target registry ----------------------------------------------------

    def add_target(self, name: str, layout: ECLayout, inode: int,
                   stripe_lens: dict[int, int]) -> ScrubTarget:
        t = ScrubTarget(name=name, layout=layout, inode=inode,
                        stripe_lens=dict(stripe_lens))
        self._targets[name] = t
        self._cursor.setdefault(name, 0)
        return t

    def remove_target(self, name: str) -> None:
        self._targets.pop(name, None)
        self._cursor.pop(name, None)
        self._discovered.discard(name)
        self._flagged = {(n, s) for n, s in self._flagged if n != name}

    async def refresh_targets(self) -> int:
        """Pull the current target set from `discovery` (no-op without
        one).  New names register fresh; retained names update their
        layout/stripe_lens IN PLACE keeping the walk cursor (a growing
        file keeps its scan position); discovery-sourced names that
        vanished (GC'd steps, unlinked files) drop out so the walk never
        probes reclaimed chunks.  Discovery failures keep the previous
        set — a flaky meta read must not blank the scrub registry."""
        if self.discovery is None:
            return len(self._targets)
        try:
            found = list(await self.discovery())
        except Exception:
            self.stats.discovery_errors += 1
            log.exception("scrub target discovery failed; keeping "
                          "previous %d targets", len(self._targets))
            return len(self._targets)
        fresh_names = set()
        for t in found:
            fresh_names.add(t.name)
            old = self._targets.get(t.name)
            if old is None:
                self.add_target(t.name, t.layout, t.inode, t.stripe_lens)
            else:
                old.layout, old.inode = t.layout, t.inode
                old.stripe_lens = dict(t.stripe_lens)
        for name in self._discovered - fresh_names:
            self.remove_target(name)
        self._discovered = fresh_names
        if self._unresolved:
            still: list[ChunkId] = []
            for cid in self._unresolved:
                hit = self.resolve_chunk(cid)
                if hit is None:
                    still.append(cid)
                else:
                    t, stripe, _slot = hit
                    self.stats.flagged_enqueued += 1
                    self._flagged.add((t.name, stripe))
            self._unresolved = still
        return len(self._targets)

    def resolve_chunk(self, chunk_id: ChunkId
                      ) -> tuple[ScrubTarget, int, int] | None:
        """Invert ECLayout chunk-id naming: ChunkId -> (target, stripe,
        slot), or None when no registered file owns the chunk."""
        for t in self._targets.values():
            lay, idx = t.layout, chunk_id.index
            if chunk_id.inode == t.inode:
                return t, idx // lay.k, idx % lay.k
            if chunk_id.inode == t.inode | PARITY_NS:
                return t, idx // lay.m, lay.k + idx % lay.m
            g = lay.num_local_groups
            if g and chunk_id.inode == t.inode | LOCAL_NS:
                return t, idx // g, lay.k + lay.m + idx % g
        return None

    def note_corrupt(self, chunk_id: ChunkId) -> bool:
        """CheckWorker corrupt_sink: queue the owning stripe for priority
        rescan.  The stripe is re-probed (not trusted blindly) so a stale
        or duplicate flag converges to a no-op; returns False when the
        chunk matches no registered file (counted, logged, dropped)."""
        hit = self.resolve_chunk(chunk_id)
        if hit is None:
            self.stats.flagged_unresolved += 1
            if self.discovery is not None and len(self._unresolved) < 1024:
                # discovery may simply not have seen the owner yet;
                # park the chunk for a retry after the next refresh
                self._unresolved.append(chunk_id)
                log.warning("scrub: corrupt chunk %s matches no target "
                            "yet; retrying after next discovery refresh",
                            chunk_id)
            else:
                log.warning("scrub: corrupt chunk %s matches no "
                            "registered EC file; dropping", chunk_id)
            return False
        t, stripe, _slot = hit
        self.stats.flagged_enqueued += 1
        self._flagged.add((t.name, stripe))
        return True

    # -- probe + classify ---------------------------------------------------

    async def _scan_stripe(self, t: ScrubTarget, stripe: int
                           ) -> tuple[list[int], list[int]]:
        """Probe every slot of one stripe; returns (lost, corrupt) slot
        lists.  Never-written stripes return empty."""
        if stripe not in t.stripe_lens:
            return [], []
        lay = t.layout
        cs, k = lay.chunk_size, lay.k
        stripe_len = t.stripe_lens[stripe]
        lens = [max(0, min(cs, stripe_len - j * cs)) for j in range(k)]
        ios = [ReadIO(chunk_id=lay.shard_chunk(t.inode, stripe, s),
                      chain_id=lay.shard_chain(stripe, s),
                      no_payload=True, verify_checksum=True)
               for s in range(lay.slots)]
        results, _ = await self.ec._fast.batch_read(ios)
        lost, corrupt = [], []
        for s, r in enumerate(results):
            self.stats.shards_probed += 1
            if s < k and lens[s] == 0:
                if r.status.code == int(StatusCode.OK):
                    corrupt.append(s)    # a hole shard must be ABSENT
                continue
            if r.status.code == int(StatusCode.CHECKSUM_MISMATCH):
                corrupt.append(s)
            elif r.status.code != int(StatusCode.OK):
                lost.append(s)
        return lost, corrupt

    async def _remove_corrupt(self, t: ScrubTarget, stripe: int,
                              corrupt: list[int]) -> None:
        lay = t.layout
        for s in corrupt:
            r = await self.ec.sc.write_chunk(
                lay.shard_chain(stripe, s),
                lay.shard_chunk(t.inode, stripe, s), 0, b"",
                chunk_size=lay.chunk_size, update_type=UpdateType.REMOVE)
            if r.status.code not in (int(StatusCode.OK),
                                     int(StatusCode.CHUNK_NOT_FOUND)):
                log.warning("scrub %s stripe %d shard %d: remove of "
                            "corrupt shard failed: %s", t.name, stripe, s,
                            r.status.message)

    # -- the scan/repair tick -----------------------------------------------

    def _pick_stripes(self, budget: int) -> list[tuple[ScrubTarget, int]]:
        """Flagged stripes first (CheckWorker detections), then the
        round-robin walk cursor across targets, `budget` stripes total."""
        picked: list[tuple[ScrubTarget, int]] = []
        for name, stripe in sorted(self._flagged):
            if len(picked) >= budget:
                break
            t = self._targets.get(name)
            if t is not None:
                picked.append((t, stripe))
            self._flagged.discard((name, stripe))
        seen = {(t.name, s) for t, s in picked}
        live = [t for t in self._targets.values() if t.num_stripes > 0]
        while len(picked) < budget and live:
            progressed = False
            for t in live:
                if len(picked) >= budget:
                    break
                cur = self._cursor[t.name]
                if cur >= t.num_stripes:
                    continue                 # this target's pass is done
                self._cursor[t.name] = cur + 1
                progressed = True
                if (t.name, cur) not in seen and cur in t.stripe_lens:
                    picked.append((t, cur))
            if not progressed:
                # every target exhausted: wrap all cursors, next tick
                # starts a fresh pass (continuous scrub)
                for t in live:
                    self._cursor[t.name] = 0
                break
        return picked

    async def scan_once(self, max_stripes: int | None = None
                        ) -> RepairReport:
        """One tick: probe up to `max_stripes` stripes, REMOVE corrupt
        shards, repair every damaged stripe through the paced driver."""
        await self.refresh_targets()
        picked = self._pick_stripes(max_stripes or self.stripes_per_tick)
        sem = asyncio.Semaphore(16)

        async def probe(t: ScrubTarget, stripe: int):
            async with sem:
                lost, corrupt = await self._scan_stripe(t, stripe)
                if corrupt:
                    await self._remove_corrupt(t, stripe, corrupt)
                return t, stripe, lost, corrupt

        outcomes = await asyncio.gather(*(probe(t, s) for t, s in picked))
        jobs: dict[str, RepairJob] = {}
        for t, stripe, lost, corrupt in outcomes:
            self.stats.stripes_scanned += 1
            self.stats.shards_lost += len(lost)
            self.stats.shards_corrupt += len(corrupt)
            bad = tuple(sorted(set(lost) | set(corrupt)))
            if not bad:
                continue
            if len(lost) == t.layout.slots:
                # every slot ABSENT, none even corrupt: the file was
                # deleted between the discovery refresh and this probe
                # (checkpoint GC races a live scan under the soak).
                # Repair from zero survivors is impossible — skip the
                # doomed job; next refresh drops the target.
                self.stats.stripes_vanished += 1
                continue
            job = jobs.get(t.name)
            if job is None:
                job = jobs[t.name] = RepairJob(
                    layout=t.layout, inode=t.inode,
                    stripe_len_of=t.stripe_lens)
            job.losses[stripe] = bad
        report = await self.driver.run(list(jobs.values()))
        self.stats.ticks += 1
        self.stats.repaired_stripes += report.repaired_stripes
        self.stats.repaired_shards += report.repaired_shards
        self.stats.stripes_failed += report.stripes_failed
        self.stats.bytes_read += report.bytes_read
        self.stats.bytes_repaired += report.bytes_repaired
        self.stats.reduced_shards += report.reduced_shards
        self.stats.fallback_shards += report.fallback_shards
        self.stats.paced_waits = report.paced_waits
        self.stats.paced_wait_s = report.paced_wait_s
        if self.report_cb is not None:
            try:
                await self.report_cb(self.status())
            except Exception:
                log.exception("scrub status report failed")
        return report

    def status(self) -> dict:
        """Health snapshot (mgmtd report / admin repair-status payload)."""
        d = dict(self.stats.__dict__)
        d["targets"] = len(self._targets)
        d["flagged_pending"] = len(self._flagged)
        d["repair_mode"] = self.driver.repair_mode
        d["budget_mbps"] = (self.driver.pacer.rate / 1e6
                            if self.driver.pacer is not None else 0.0)
        return d

    # -- background loop ----------------------------------------------------

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="scrub-sched")

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "scrub scheduler")

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.period_s)
            try:
                await self.scan_once()
            except Exception:
                log.exception("scrub tick failed")
