"""KVCache scale bench: millions-of-sessions trajectory on one host.

The cliff this bench guards: a namespace ledger that never compacted
would grow its replay cost and segment count with HISTORY, not with the
live set — a namespace serving production churn for weeks would pay
minutes of replay on every attach.  And per-process admission would bound
the session count by what one process could politely admit.

This bench drives ≥100k live sessions (zipf-skewed across tenant
namespaces, one admission plane with weighted shards, ring data plane)
and records the two curves that prove the fix:

- **Scale curve**: at each session-count checkpoint, get p50/p99 over
  byte-verified reads, fresh-reader replay wall time, replayed record
  count, and live segment count.  Replay grows with the live set —
  linear in sessions, not in operations.
- **Compaction A/B**: churn one tenant's namespace (overwrite + DEL
  rounds) to inflate history, measure a fresh reader's replay of the
  uncompacted ledger, then compact WITH A CONCURRENT WRITER running
  and measure again.  Acceptance: >= 5x faster replay at equal history
  depth, zero lost or wrong keys (every live value byte-verified).

    python -m t3fs_torch.benchmarks.kvcache_scale_bench --json          # full, 100k
    python -m t3fs_torch.benchmarks.kvcache_scale_bench --smoke --json  # CI lane

The port of benchmarks/kvcache_scale_bench.py, with the same arguments,
defaults, gates and JSON keys.  The fabric's nodes checksum on the CUDA
backend (payloads of 64 KiB and more on the card); without a GPU the bench
raises, and --cpu runs every node's CRC on the host backend.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import random
import sys
import time
import uuid

from t3fs_torch import resolve_device


def _value_for(key: bytes, size: int) -> bytes:
    """Deterministic value: the verifier recomputes instead of holding
    100k values in memory."""
    seed = hashlib.blake2b(key, digest_size=16).digest()
    reps = size // len(seed) + 1
    return (seed * reps)[:size]


def _pctl(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(len(s) * q), len(s) - 1)]


def _tenant_of(rng: random.Random, tenants: int, alpha: float) -> int:
    return min(int(rng.paretovariate(alpha)) - 1, tenants - 1) % tenants


class _Fleet:
    """One tier per tenant namespace, all sharing an admission plane
    (weighted shards), all on one ring-plane client."""

    def __init__(self, sc, chain_ids, args, group: str):
        from t3fs_torch.kvcache import KVCacheTier, KVCacheTierConfig
        self.args = args
        self.tiers = []
        for t in range(args.tenants):
            cfg = KVCacheTierConfig(
                block_size=1 << (args.value_size + 256 - 1).bit_length(),
                lanes=8, hit_sample=4,
                ledger_flush_interval_s=0.05,
                admit_window=args.admit_window,
                admit_shards=args.admit_shards,
                admit_group=group,
                compact_trigger_segments=1 << 30,   # manual passes only
                compact_rate=20000.0, compact_burst=2048,
                compact_del_grace_s=0.5)
            self.tiers.append(KVCacheTier(
                sc, chain_ids, namespace=f"tenant-{t}", config=cfg,
                writer_id=100 + t))

    async def start(self):
        for tier in self.tiers:
            await tier.start()

    async def stop(self):
        for tier in self.tiers:
            await tier.stop()

    async def flush(self):
        for tier in self.tiers:
            await tier.flush()


async def _put_sessions(fleet: _Fleet, assign: list, start: int,
                        end: int, value_size: int,
                        concurrency: int = 256) -> None:
    sem = asyncio.Semaphore(concurrency)

    async def one(i: int) -> None:
        tier = fleet.tiers[assign[i]]
        key = f"t{assign[i]}/sess-{i:07d}".encode()
        async with sem:
            await tier.put(key, _value_for(key, value_size))

    await asyncio.gather(*(one(i) for i in range(start, end)))


async def _sample_gets(fleet: _Fleet, assign: list, upto: int,
                       value_size: int, samples: int, rng: random.Random
                       ) -> tuple[list, int]:
    """(per-get latencies, wrong_bytes) over byte-verified random gets."""
    idxs = [rng.randrange(upto) for _ in range(samples)]
    lat: list = []
    wrong = 0
    sem = asyncio.Semaphore(64)

    async def one(i: int) -> None:
        nonlocal wrong
        tier = fleet.tiers[assign[i]]
        key = f"t{assign[i]}/sess-{i:07d}".encode()
        async with sem:
            t0 = time.perf_counter()
            v = await tier.get(key)
            lat.append(time.perf_counter() - t0)
        if v != _value_for(key, value_size):
            wrong += 1

    await asyncio.gather(*(one(i) for i in idxs))
    return lat, wrong


async def _replay_cost(store, lanes: int) -> dict:
    """What a fresh process pays to learn the namespace: full scan +
    table build, from zero frontiers."""
    from t3fs_torch.kvcache import LedgerReader, LedgerTable
    reader = LedgerReader(store, lanes=lanes)
    t0 = time.perf_counter()
    records = await reader.scan()
    table = LedgerTable()
    table.apply(records)
    elapsed = time.perf_counter() - t0
    return {"replay_s": elapsed, "records": len(records),
            "segments": reader.live_segments(), "live_keys": len(table),
            "table": table}


async def _compaction_ab(fleet: _Fleet, assign: list, total: int,
                         args) -> dict:
    """Churn one tenant to inflate its ledger HISTORY far past its live
    set, then A/B a fresh reader's replay cost across one forced
    compaction pass racing live writer traffic.

    The churn tenant is the smallest non-empty one: the replay-speedup
    contrast is history/live, so the live set must not dominate."""
    counts = [sum(1 for a in assign if a == t) for t in range(args.tenants)]
    tenant = min((t for t in range(args.tenants) if counts[t] > 0),
                 key=lambda t: counts[t])
    tier = fleet.tiers[tenant]
    keys = [f"t{tenant}/sess-{i:07d}".encode()
            for i in range(total) if assign[i] == tenant]
    churn = keys[:args.churn_keys]

    # history inflation: every churn key overwritten per round, flushed
    # per round so each rewrite leaves a ledger record (within one flush
    # window the write-behind coalesces rewrites away — correct for
    # serving, but here we are simulating hours of spaced-out churn)
    for _r in range(args.churn_rounds):
        sem = asyncio.Semaphore(256)

        async def one(key: bytes) -> None:
            async with sem:
                await tier.put(key, _value_for(key, args.value_size))

        await asyncio.gather(*(one(k) for k in churn))
        await tier.flush()
    # a third of the churn keys die AFTER all their puts are durable and
    # ledgered (a DEL racing an unflushed put would lose to its newer
    # flush-time ts — the grace-window case, tested elsewhere)
    for key in churn[::3]:
        await tier.store.remove_keys([key])
        tier.ledger.append(2, key, ts=time.time())       # OP_DEL
    await tier.flush()

    before = await _replay_cost(tier.store, tier.cfg.lanes)
    table_before = before.pop("table")
    dead = {k for k in churn[::3] if k not in table_before.entries}

    # concurrent writer: live traffic must keep flowing (and keep its
    # records) THROUGH the compaction pass; paced so the A/B measures
    # compaction, not loop starvation by an unthrottled producer
    stop = asyncio.Event()
    racing: list = []

    async def traffic() -> None:
        i = 0
        while not stop.is_set():
            key = f"t{tenant}/race-{i:05d}".encode()
            await tier.put(key, _value_for(key, args.value_size))
            racing.append(key)
            i += 1
            await asyncio.sleep(0.002)

    task = asyncio.create_task(traffic())
    t0 = time.perf_counter()
    pass_out = await tier.run_compaction_pass(force=True)
    compact_s = time.perf_counter() - t0
    stop.set()
    await task
    await tier.flush()

    after = await _replay_cost(tier.store, tier.cfg.lanes)
    table_after = after.pop("table")

    # correctness: every key the pre-compaction replay called live, and
    # every racing write, must be live with the right bytes; every
    # deleted key must stay dead
    lost = wrong = 0
    live = [k for k in table_before.entries if k not in dead] + racing
    for i in range(0, len(live), 512):
        batch = live[i:i + 512]
        values = await tier.get_many(batch)
        for key, v in zip(batch, values):
            if v is None:
                lost += 1
            elif v != _value_for(key, args.value_size):
                wrong += 1
    resurrected = sum(1 for k in dead if k in table_after.entries)

    speedup = before["replay_s"] / max(1e-9, after["replay_s"])
    # the racing writer's records are new content, not surviving
    # history: subtract them when judging how well compaction bounded
    # the replay of the PRE-EXISTING history
    after_adj_records = max(0, after["records"] - len(racing))
    return {
        "tenant": tenant, "churn_keys": len(churn),
        "churn_rounds": args.churn_rounds,
        "racing_writes": len(racing),
        "after_records_less_racing": after_adj_records,
        "before": {k: round(v, 4) if isinstance(v, float) else v
                   for k, v in before.items()},
        "after": {k: round(v, 4) if isinstance(v, float) else v
                  for k, v in after.items()},
        "pass": {k: pass_out[k] for k in
                 ("segments", "records_in", "records_out", "retired",
                  "fence_lost", "orphans")},
        "compact_wall_s": round(compact_s, 3),
        "replay_speedup": round(speedup, 2),
        "record_ratio": round(before["records"]
                              / max(1, after["records"]), 2),
        "lost_keys": lost, "wrong_bytes": wrong,
        "resurrected_dels": resurrected,
    }


async def run_bench(args) -> dict:
    from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
    from t3fs_torch.testing.fabric import StorageFabric

    fab = StorageFabric(num_nodes=args.nodes, replicas=args.replicas,
                        num_chains=args.chains,
                        checksum_backend=args.checksum_backend,
                        write_pipeline="streamed")
    await fab.start()
    sc = StorageClient(lambda: fab.routing, client=fab.client,
                       config=StorageClientConfig(data_plane="ring"))
    group = f"t3fs-scale-{uuid.uuid4().hex[:12]}"
    rng = random.Random(args.seed)
    assign = [_tenant_of(rng, args.tenants, args.zipf_alpha)
              for _ in range(args.sessions)]
    fleet = _Fleet(sc, fab.chain_ids, args, group)
    try:
        await fleet.start()
        curve = []
        done = 0
        wrong_total = 0
        for target in args.checkpoints:
            target = min(target, args.sessions)
            if target <= done:
                continue
            await _put_sessions(fleet, assign, done, target,
                                args.value_size)
            done = target
            await fleet.flush()
            lat, wrong = await _sample_gets(
                fleet, assign, done, args.value_size,
                args.get_samples, random.Random(args.seed + done))
            wrong_total += wrong
            replay = {"replay_s": 0.0, "records": 0, "segments": 0,
                      "live_keys": 0}
            for tier in fleet.tiers:
                r = await _replay_cost(tier.store, tier.cfg.lanes)
                r.pop("table")
                for k in replay:
                    replay[k] += r[k]
            curve.append({
                "sessions": done,
                "get_p50_ms": round(_pctl(lat, 0.5) * 1e3, 3),
                "get_p99_ms": round(_pctl(lat, 0.99) * 1e3, 3),
                "replay_s": round(replay["replay_s"], 4),
                "replay_records": replay["records"],
                "segments": replay["segments"],
                "live_keys": replay["live_keys"],
                "wrong_bytes": wrong,
            })
        ab = await _compaction_ab(fleet, assign, done, args)
        wrong_total += ab["wrong_bytes"]

        # shard skew: zipf tenants spread over the plane's shards
        plane = fleet.tiers[0].plane
        shards = plane.stats()["per_shard"]
        ring_on = (sc._ring_state["ring"] is not None       # noqa: SLF001
                   and not sc._ring_state["failed"])        # noqa: SLF001
        out = {
            "sessions": done, "tenants": args.tenants,
            "zipf_alpha": args.zipf_alpha,
            "data_plane": "ring" if ring_on else "rpc-fallback",
            "admit_shards": args.admit_shards,
            "shard_admits": [s["admitted"] for s in shards],
            "curve": curve,
            "compaction_ab": ab,
            "wrong_bytes": wrong_total,
            "gates": {
                "zero_wrong_bytes": wrong_total == 0,
                "zero_lost_keys": ab["lost_keys"] == 0,
                "no_resurrected_dels": ab["resurrected_dels"] == 0,
                "replay_speedup_5x": ab["replay_speedup"] >= 5.0,
                "bounded_replay": (
                    ab["after_records_less_racing"]
                    < ab["before"]["records"] / 3),
            },
        }
        await fleet.stop()
        return out
    finally:
        await sc.close()
        await fab.stop()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="kvcache_scale_bench")
    ap.add_argument("--sessions", type=int, default=100_000)
    ap.add_argument("--checkpoints", type=str, default="")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--zipf-alpha", type=float, default=1.2)
    ap.add_argument("--value-size", type=int, default=192)
    ap.add_argument("--get-samples", type=int, default=1500)
    ap.add_argument("--churn-keys", type=int, default=3000)
    ap.add_argument("--churn-rounds", type=int, default=12)
    ap.add_argument("--admit-window", type=int, default=256)
    ap.add_argument("--admit-shards", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--smoke", action="store_true",
                    help="CI lane: small storm, one forced compaction "
                         "cycle, same correctness gates")
    ap.add_argument("--cpu", action="store_true",
                    help="run the nodes' CRCs on the host backend")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    args.checksum_backend = "cpu" if args.cpu else "cuda"
    if args.smoke:
        args.sessions = min(args.sessions, 2000)
        args.tenants = min(args.tenants, 4)
        args.get_samples = min(args.get_samples, 300)
        args.churn_keys = min(args.churn_keys, 300)
        args.churn_rounds = min(args.churn_rounds, 8)
    if args.checkpoints:
        args.checkpoints = [int(x) for x in args.checkpoints.split(",")]
    else:
        args.checkpoints = [args.sessions // 8, args.sessions // 4,
                            args.sessions // 2, args.sessions]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card unless asked for the host: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    result = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(result))
    else:
        print(json.dumps(result, indent=2))
    gates = result["gates"]
    hard = ["zero_wrong_bytes", "zero_lost_keys", "no_resurrected_dels",
            "bounded_replay"]
    if not args.smoke:
        hard.append("replay_speedup_5x")      # timing gate: full runs only
    failed = [g for g in hard if not gates[g]]
    if failed:
        print(f"GATES FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
