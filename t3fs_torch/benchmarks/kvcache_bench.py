"""KVCache bench: batched-get IOPS + GC removal IOPS over KVCacheStore.

Reference analog: the README.md:45-51 KVCache figures (peak read throughput,
GC removal IOPS).  Drives t3fs_torch/lib/kvcache.py against the in-process fabric
(default) or a live cluster (--mgmtd).

    python -m t3fs_torch.benchmarks.kvcache_bench --blocks 2048 --value-size 16384 \
        --batch 32 --concurrency 16 --seconds 5 --json

The port of benchmarks/kvcache_bench.py, with the same arguments, defaults
and JSON keys.  The in-process fabric's nodes checksum on the CUDA backend
(payloads of 64 KiB and more on the card, smaller ones on the host, as in
the reference); without a GPU the bench raises.  --cpu runs every node's
CRC on the host backend.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time

from t3fs_torch import resolve_device
from t3fs_torch.lib.kvcache import KVCacheConfig, KVCacheStore
from t3fs_torch.utils.metrics import LatencyRecorder


async def run_bench(args) -> dict:
    from t3fs_torch.benchmarks._env import make_env
    env, sc, chains = await make_env(args)
    block_cap = 1 << (args.value_size + 256 - 1).bit_length()
    kv = KVCacheStore(sc, chains, namespace=f"bench-{args.seed}",
                      config=KVCacheConfig(block_size=block_cap,
                                           gc_concurrency=args.concurrency))
    try:
        return await _run_phases(args, kv)
    finally:
        await sc.close()
        await env.stop()


async def _run_phases(args, kv: KVCacheStore) -> dict:
    rng = random.Random(args.seed)
    keys = [f"kv-{args.seed}-{i}".encode() for i in range(args.blocks)]
    value = bytes(rng.getrandbits(8) for _ in range(256)) * (
        args.value_size // 256 + 1)
    value = value[:args.value_size]

    # populate
    t0 = time.perf_counter()
    await asyncio.gather(*(kv.put(k, value) for k in keys))
    t_pop = time.perf_counter() - t0

    # batched random gets
    lat = LatencyRecorder("kvcache.get_many")
    counters = {"ops": 0, "bytes": 0, "miss": 0}
    stop_at = time.perf_counter() + args.seconds

    async def getter(widx: int) -> None:
        g = random.Random(args.seed * 1000 + widx)
        while time.perf_counter() < stop_at:
            batch = [keys[g.randrange(len(keys))] for _ in range(args.batch)]
            with lat.time():
                values = await kv.get_many(batch)
            for v in values:
                if v is None:
                    counters["miss"] += 1
                else:
                    counters["ops"] += 1
                    counters["bytes"] += len(v)

    t0 = time.perf_counter()
    await asyncio.gather(*(getter(w) for w in range(args.concurrency)))
    t_get = time.perf_counter() - t0
    snap = lat.collect()

    # GC removal
    t0 = time.perf_counter()
    removed = await kv.remove_many(keys)
    t_gc = time.perf_counter() - t0

    return {
        "blocks": args.blocks, "value_size": args.value_size,
        "batch": args.batch, "concurrency": args.concurrency,
        "populate_put_iops": round(args.blocks / t_pop, 1),
        "get_iops": round(counters["ops"] / t_get, 1),
        "get_MB_s": round(counters["bytes"] / t_get / 1e6, 2),
        "get_miss": counters["miss"],
        "get_p50_ms": round(snap.get("p50", 0) * 1e3, 3),
        "get_p99_ms": round(snap.get("p99", 0) * 1e3, 3),
        "gc_removed": removed,
        "gc_remove_iops": round(removed / t_gc, 1),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="kvcache_bench")
    ap.add_argument("--mgmtd", default="",
                    help="live cluster address; omit for in-process fabric")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=1024)
    ap.add_argument("--value-size", type=int, default=16 << 10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-aio", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the nodes' CRCs on the host backend")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    args.checksum_backend = "cpu" if args.cpu else "cuda"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card unless asked for the host: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    result = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f"{k:>18}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
