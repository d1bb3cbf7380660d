"""RepairDriver: cluster-wide EC rebuild scheduling, balanced like the
placement solver plans it.

Reference analog: the BIBD placement solver balances *recovery traffic*
(deploy/data_placement/src/model/data_placement.py:30,484) — when a disk
dies, every chain that shared stripes with it sources survivor reads, and
the whole point of the balanced design is that no single surviving chain
becomes the rebuild bottleneck.  The reference's recovery is replica
resync; t3fs recovery is RS decode, so the driver must do what the solver
assumed: schedule stripe repairs so survivor-READ load stays even across
chains while rebuilt shards stream back to the recovered targets.

Scheduling: each stripe repair reads k survivor shards (one chain each)
and writes the lost shards.  The driver greedily orders pending stripes by
the current least-loaded-chain metric — at each step it picks the stripe
whose survivor set's maximum per-chain outstanding load is smallest, then
runs up to `concurrency` repairs with that ordering (an online version of
the solver's balance objective; exact assignment is the ILP the solver
already solved at placement time).

The port of t3fs/client/repair.py over t3fs_torch.client.ec_client.
"""

from __future__ import annotations

import asyncio
import logging
from collections import defaultdict
from dataclasses import dataclass, field

from t3fs_torch.client.ec_client import ECLayout, ECStorageClient, RepairIOStats
from t3fs_torch.utils.status import StatusCode

log = logging.getLogger("t3fs_torch.repair")


class TokenBucketPacer:
    """Byte-rate token bucket for repair pacing (the _HedgeBudget shape, in
    bytes/s): acquire(nbytes) WAITS until the budget earns enough tokens —
    exhaustion is backpressure, never an error, so rebuild under a tight
    `storage.repair_budget_mbps` slows down instead of failing stripes.

    `burst_bytes` caps the idle accumulation (default one second of rate);
    `floor_bytes` is the minimum grant capacity, so a single request larger
    than the burst (one big stripe) clamps to the capacity and proceeds
    after draining it rather than deadlocking on tokens that can never
    accrue.  rate_mbps <= 0 disables pacing entirely."""

    def __init__(self, rate_mbps: float, burst_bytes: int | None = None,
                 floor_bytes: int = 1 << 20):
        self.rate = rate_mbps * 1e6                    # bytes per second
        self.capacity = max(int(burst_bytes if burst_bytes is not None
                                else self.rate), floor_bytes)
        self.tokens = float(self.capacity)
        self._last: float | None = None
        self._lock = asyncio.Lock()
        self.waits = 0
        self.waited_s = 0.0

    def _refill(self) -> None:
        import time
        now = time.monotonic()
        if self._last is not None:
            self.tokens = min(float(self.capacity),
                              self.tokens + (now - self._last) * self.rate)
        self._last = now

    async def acquire(self, nbytes: int) -> None:
        if self.rate <= 0:
            return
        take = float(min(nbytes, self.capacity))
        # serialized: FIFO fairness, and one sleeper computes exact deficit
        async with self._lock:
            self._refill()
            if self.tokens < take:
                wait = (take - self.tokens) / self.rate
                self.waits += 1
                self.waited_s += wait
                await asyncio.sleep(wait)
                self._refill()
            self.tokens -= take       # may dip below 0 on clock skew: debt


@dataclass
class RepairJob:
    """One file's losses: stripes -> lost shard indices."""
    layout: ECLayout
    inode: int
    stripe_len_of: dict[int, int]               # stripe -> true data length
    losses: dict[int, tuple[int, ...]] = field(default_factory=dict)


@dataclass
class RepairReport:
    repaired_stripes: int = 0
    repaired_shards: int = 0
    failed: list[tuple[int, int]] = field(default_factory=list)  # (inode, stripe)
    max_chain_reads: int = 0
    min_chain_reads: int = 0
    # IO accounting: what rebuilding cost the fabric.  The drill
    # metric is bytes_read / bytes_repaired — full-k repair pays ~k, the
    # reduced-read path ~group_size.
    bytes_read: int = 0
    bytes_repaired: int = 0
    stripes_failed: int = 0
    reduced_shards: int = 0
    fallback_shards: int = 0
    sub_reads: int = 0
    paced_waits: int = 0
    paced_wait_s: float = 0.0


class RepairDriver:
    """Schedules `ECStorageClient.repair_stripe` calls across many files,
    survivor-read-balanced; optionally paced by a byte-rate token bucket
    and routed down the reduced-read sub-shard path."""

    def __init__(self, ec: ECStorageClient, concurrency: int = 8,
                 initial_load: dict[int, int] | None = None,
                 repair_mode: str = "subshard",
                 budget_mbps: float = 0.0,
                 budget_burst_bytes: int | None = None):
        assert repair_mode in ("subshard", "full"), repair_mode
        self.ec = ec
        self.concurrency = concurrency
        self.repair_mode = repair_mode
        self.pacer = (TokenBucketPacer(budget_mbps, budget_burst_bytes)
                      if budget_mbps > 0 else None)
        # exact placement weights (mgmtd.placement.chain_recovery_weights):
        # chains the failure already loaded (resync sources, degraded-read
        # targets) start with their standing weight, so the survivor picks
        # steer around them instead of discovering the hotspot online
        self.initial_load = dict(initial_load or {})
        self._warmed: set[tuple] = set()

    async def warmup(self, layouts: list[ECLayout]) -> None:
        """Precompile each distinct layout's repair programs (off the event
        loop — compiles run on the codec thread) so the first repaired
        stripe doesn't eat the kernel build; run() calls this itself."""
        for lay in layouts:
            key = (lay.k, lay.m, lay.chunk_size, lay.code_id,
                   lay.local_scheme, lay.local_group_size)
            if key in self._warmed:
                continue
            self._warmed.add(key)
            await asyncio.to_thread(self.ec.warmup_repair, lay)

    def plan(self, jobs: list[RepairJob]
             ) -> tuple[list[tuple["RepairJob", int, tuple[int, ...]]],
                        list[tuple[int, int]]]:
        """Choose, per stripe, WHICH k survivors to read and in what
        order, so survivor-read load stays flat across chains; returns
        (ordered [(job, stripe, chosen_shard_indices)], unrepairable
        [(inode, stripe)] — stripes with NO surviving shard).

        Decode needs exactly k of the k+m-|lost| survivors — reading all
        of them both wastes IO and concentrates load.  Each stripe takes
        the k survivors whose chains carry the least accumulated load
        (seeded from initial_load, the solver's exact weights).  Ordering
        uses a lazy-reevaluation heap: a popped entry whose score went
        stale is re-scored and re-pushed — O(P log P) typical instead of
        the naive O(P^2) scan, which would stall the event loop for
        minutes at cluster scale."""
        import heapq

        pending: list[tuple[RepairJob, int, list[tuple[int, int]]]] = []
        unrepairable: list[tuple[int, int]] = []
        for job in jobs:
            for stripe, lost in sorted(job.losses.items()):
                if not lost:
                    continue
                lay = job.layout
                lost_set = set(lost)
                survivors = [(s, lay.shard_chain(stripe, s))
                             for s in range(lay.k + lay.m)
                             if s not in lost_set]
                if not survivors:
                    unrepairable.append((job.inode, stripe))
                    continue
                pending.append((job, stripe, survivors))
        load: dict[int, int] = defaultdict(int, self.initial_load)

        def choose(entry) -> tuple[list[tuple[int, int]], int]:
            """k least-loaded survivors (all of them when fewer than k
            survive — the decode needs everything it can get) and the
            resulting score."""
            k = entry[0].layout.k
            ranked = sorted(entry[2], key=lambda sc: (load[sc[1]], sc[1]))
            chosen = ranked[:k]
            return chosen, max(load[c] for _s, c in chosen)

        heap = [(0, i) for i in range(len(pending))]
        heapq.heapify(heap)
        ordered: list[tuple[RepairJob, int, tuple[int, ...]]] = []
        while heap:
            s, i = heapq.heappop(heap)
            chosen, cur = choose(pending[i])
            if cur != s:
                heapq.heappush(heap, (cur, i))   # stale: re-score
                continue
            job, stripe, _survivors = pending[i]
            for _shard, c in chosen:
                load[c] += 1
            ordered.append((job, stripe,
                            tuple(shard for shard, _c in chosen)))
        return ordered, unrepairable

    def _estimate_read_bytes(self, lay: ECLayout,
                             lost: tuple[int, ...]) -> int:
        """Pacing charge for one stripe: what its survivor reads should
        cost.  The bucket meters intent, so the estimate errs high (holes
        and short tails read fewer bytes than charged) — pacing must bound
        fabric load, not track it exactly."""
        cs = lay.chunk_size
        if self.repair_mode == "subshard" and lay.local_scheme == "pm-msr":
            from t3fs_torch.ops.msr import default_msr
            code = default_msr(lay.k, lay.m)
            if len(lost) == 1:
                # every survivor ships its beta/alpha projection: d helpers
                # x beta sub-chunks = 0.5625x of k full chunks
                return code.d * code.beta * cs // code.alpha
            return lay.k * cs        # multi-loss: joint decode, exactly k
        if self.repair_mode == "subshard" and lay.local_scheme:
            groups = lay.local_groups()
            base = lay.k + lay.m
            return sum(
                len(groups[s - base if s >= base else lay.group_of(s)]) * cs
                for s in lost)
        return lay.k * cs

    async def run(self, jobs: list[RepairJob]) -> RepairReport:
        await self.warmup([j.layout for j in jobs])
        ordered, unrepairable = self.plan(jobs)
        stats = RepairIOStats()
        report = RepairReport()
        report.failed.extend(unrepairable)
        for inode, stripe in unrepairable:
            log.warning("repair inode %d stripe %d: no surviving shards",
                        inode, stripe)
        # PLANNED survivor reads per chain (a failed preferred read falls
        # through to the patient wave and may touch other chains; zero-
        # hole shards substitute for free — the metric reflects the plan,
        # which is what the balancer controls).  Every candidate survivor
        # chain starts at 0 so a chain the picker left idle shows up in
        # min_chain_reads instead of being silently excluded.
        chain_reads: dict[int, int] = defaultdict(int)
        for job, stripe, _chosen in ordered:
            lost_set = set(job.losses[stripe])
            for s in range(job.layout.k + job.layout.m):
                if s not in lost_set:
                    chain_reads[job.layout.shard_chain(stripe, s)] += 0
        sem = asyncio.Semaphore(self.concurrency)

        async def one(job: RepairJob, stripe: int,
                      read_shards: tuple[int, ...]) -> None:
            lost = job.losses[stripe]
            async with sem:
                if self.pacer is not None:
                    await self.pacer.acquire(
                        self._estimate_read_bytes(job.layout, lost))
                try:
                    results = await self.ec.repair_stripe(
                        job.layout, job.inode, stripe, lost,
                        stripe_len=job.stripe_len_of.get(
                            stripe, job.layout.k * job.layout.chunk_size),
                        read_shards=read_shards, mode=self.repair_mode,
                        stats=stats)
                except Exception as e:
                    log.warning("repair inode %d stripe %d failed: %s",
                                job.inode, stripe, e)
                    report.failed.append((job.inode, stripe))
                    return
                if all(r.status.code == int(StatusCode.OK)
                       for r in results):
                    report.repaired_stripes += 1
                    report.repaired_shards += len(lost)
                    for s in read_shards:    # the set the planner balanced
                        chain_reads[job.layout.shard_chain(stripe, s)] += 1
                else:
                    report.failed.append((job.inode, stripe))

        await asyncio.gather(*(one(j, s, sv) for j, s, sv in ordered))
        if chain_reads:
            report.max_chain_reads = max(chain_reads.values())
            report.min_chain_reads = min(chain_reads.values())
        report.bytes_read = stats.bytes_read
        report.bytes_repaired = stats.bytes_repaired
        report.reduced_shards = stats.reduced_shards
        report.fallback_shards = stats.fallback_shards
        report.sub_reads = stats.sub_reads
        report.stripes_failed = len(report.failed)
        if self.pacer is not None:
            report.paced_waits = self.pacer.waits
            report.paced_wait_s = self.pacer.waited_s
        return report
