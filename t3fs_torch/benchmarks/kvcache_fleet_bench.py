"""KVCache fleet bench: a multi-process inference fleet over one tier.

Reference analog: the README KVCache figures, but measured the way an
inference fleet actually hits the cache — many worker processes, each
serving hundreds of concurrent sessions, zipf-popular prompts sharing
prefix chains, write-behind buffering the KV block puts, and a GC worker
reclaiming the namespace afterwards.

Topology: the parent starts a StorageFabric (real TCP servers,
``write_pipeline=streamed``); each worker process reconnects with its own
client from a serialized routing snapshot and runs ``--sessions``
concurrent sessions.  Every session replays ``--turns`` prompts drawn
zipf-style from ``--prompts`` templates: probe the prefix chain with one
batched get, then put the missing suffix blocks.  Phase two measures GC
removal IOPS by evicting the namespace down to half its live bytes.

The run is an A/B: write-behind ON vs OFF (same fleet, fresh namespace
per side) — the put p50 delta is the number the tier exists for.

``--admission-ab`` adds a second A/B over the admission plane: the same
fleet with ``admit_scope=host`` (one shm token arena for every process)
vs ``admit_scope=process`` (the historical per-process semaphores).
The host cell ASSERTS the host-wide in-flight bound held — the arena's
peak can never exceed the configured window; the process cell measures
how far N private windows over-admit (time-bucketed sum of concurrent
holders across processes).

    python -m t3fs_torch.benchmarks.kvcache_fleet_bench --procs 6 --sessions 512 \
        --turns 2 --admission-ab --json   # the BENCH_e2e.json config
    python -m t3fs_torch.benchmarks.kvcache_fleet_bench --procs 2 --sessions 8 \
        --turns 1 --prompts 16 --blocks 4 --json    # smoke (CI)

The port of benchmarks/kvcache_fleet_bench.py, with the same arguments,
defaults and JSON keys.  The parent's storage nodes checksum on the CUDA
backend (payloads of 64 KiB and more on the card), so without a GPU the
bench raises; --cpu runs their CRCs on the host backend.  The workers run
clients only and never touch the card: each checks, before it reports,
that it did not initialise CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import multiprocessing as mp
import random
import sys
import time
import uuid

from t3fs_torch import resolve_device


# ---------------- routing over process boundaries ----------------

def freeze_routing(routing) -> dict:
    """RoutingInfo -> plain picklable dict (spawn children rebuild it)."""
    return {
        "version": routing.version,
        "nodes": {nid: n.address for nid, n in routing.nodes.items()},
        "chains": {cid: [(t.target_id, t.node_id) for t in c.targets]
                   for cid, c in routing.chains.items()},
    }


def thaw_routing(blob: dict):
    from t3fs_torch.mgmtd.types import (
        ChainInfo, ChainTargetInfo, NodeInfo, PublicTargetState, RoutingInfo,
    )
    routing = RoutingInfo(version=blob["version"])
    for nid, addr in blob["nodes"].items():
        routing.nodes[nid] = NodeInfo(nid, addr)
    for cid, targets in blob["chains"].items():
        routing.chains[cid] = ChainInfo(
            chain_id=cid, chain_ver=1,
            targets=[ChainTargetInfo(tid, nid, PublicTargetState.SERVING)
                     for tid, nid in targets])
    return routing


# ---------------- worker process ----------------

def _pick_prompt(rng: random.Random, prompts: int, alpha: float) -> int:
    # zipf-ish: pareto rank, folded into the template space
    return min(int(rng.paretovariate(alpha)) - 1, prompts - 1) % prompts


async def _session(tier, sid: int, args, lat_get: list, lat_put: list,
                   counters: dict) -> None:
    from t3fs_torch.lib.kvcache import KVCacheStore
    rng = random.Random(args.seed * 100_000 + sid)
    value = (f"kv{sid}".encode() * (args.value_size // 4 + 1))
    value = value[:args.value_size]
    for _turn in range(args.turns):
        p = _pick_prompt(rng, args.prompts, args.zipf_alpha)
        blocks = [f"prompt{p}-blk{i}".encode() for i in range(args.blocks)]
        keys = KVCacheStore.prefix_keys(f"model-{args.seed}", [
            f"p{p}".encode()] + blocks)
        t0 = time.perf_counter()
        values = await tier.get_many(keys)
        lat_get.append(time.perf_counter() - t0)
        n_hit = 0
        for v in values:
            if v is None:
                break
            n_hit += 1
        counters["hits"] += n_hit
        counters["misses"] += len(keys) - n_hit
        for i in range(n_hit, len(keys)):
            t0 = time.perf_counter()
            await tier.put(keys[i], value)
            lat_put.append(time.perf_counter() - t0)
    # publish barrier: the session's blocks must be durable before other
    # workers can rely on the prefix
    await tier.flush()


async def _worker_async(proc_idx: int, routing_blob: dict,
                        chain_ids: list, args, wb_mode: str,
                        namespace: str, q) -> None:
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.kvcache import KVCacheTier, KVCacheTierConfig
    from t3fs_torch.net.client import Client
    from t3fs_torch.net.rdma import BufferRegistry

    routing = thaw_routing(routing_blob)
    cli = Client()
    cli.add_service(BufferRegistry())
    sc = StorageClient(lambda: routing, client=cli)
    admit_window = args.admit_window or args.sessions * 2
    cfg = KVCacheTierConfig(
        block_size=1 << (args.value_size + 256 - 1).bit_length(),
        write_behind=wb_mode, lanes=max(32, args.procs),
        hit_sample=8, admit_window=admit_window,
        # class windows must not bind tighter than the namespace window
        # under a small --admit-window, or the A/B measures the wrong cap
        admit_class_windows=(admit_window, admit_window, admit_window),
        admit_scope=args.admit_scope,
        admit_group=getattr(args, "admit_group", ""))
    tier = KVCacheTier(sc, chain_ids, namespace=namespace, config=cfg,
                       writer_id=proc_idx)
    await tier.start()
    lat_get: list = []
    lat_put: list = []
    counters = {"hits": 0, "misses": 0}

    # time-bucketed holder samples: the process cell's over-admission is
    # only visible as CONCURRENT holders summed across processes
    held_samples: list = []

    async def _sample_held() -> None:
        while True:
            held_samples.append((time.time(), tier.admission.held_now))
            await asyncio.sleep(0.002)

    sampler = asyncio.create_task(_sample_held())
    t0 = time.perf_counter()
    await asyncio.gather(*(
        _session(tier, proc_idx * args.sessions + s, args,
                 lat_get, lat_put, counters)
        for s in range(args.sessions)))
    elapsed = time.perf_counter() - t0
    sampler.cancel()
    stats = tier.stats()
    adm = stats["admission"]
    host_peak = tier.plane.host_peak(tier.admission.shard)
    await tier.stop()
    await sc.close()
    rng = random.Random(proc_idx)
    q.put({
        "proc": proc_idx, "elapsed_s": elapsed,
        "hits": counters["hits"], "misses": counters["misses"],
        "gets": len(lat_get), "puts": len(lat_put),
        # sampled so 4 procs x tens of thousands of ops stay queue-sized
        "lat_get": rng.sample(lat_get, min(len(lat_get), 4000)),
        "lat_put": rng.sample(lat_put, min(len(lat_put), 4000)),
        "coalesced": stats.get("write_behind", {}).get("coalesced", 0),
        "backpressure": stats.get("write_behind", {})
                             .get("backpressure_waits", 0),
        "adm_scope": adm["scope"], "adm_peak_held": adm["peak_held"],
        "adm_waits": adm["waits"], "adm_host_peak": host_peak,
        "held_samples": held_samples[:20000],
    })


def _worker(proc_idx, routing_blob, chain_ids, args_dict, wb_mode,
            namespace, q):
    args = argparse.Namespace(**args_dict)
    asyncio.run(_worker_async(proc_idx, routing_blob, chain_ids, args,
                              wb_mode, namespace, q))
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(f"fleet worker {proc_idx} initialised CUDA")


# ---------------- parent ----------------

def _pctl(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(len(s) * q), len(s) - 1)]


def _concurrent_held_peak(results: list, bucket_s: float = 0.01) -> int:
    """Peak of (sum across processes of concurrent admission holders),
    from the workers' time-bucketed samples — the honest cross-process
    concurrency measure (summing per-proc peaks would conflate peaks
    from different moments)."""
    buckets: dict[int, int] = {}
    for r in results:
        per: dict[int, int] = {}
        for t, held in r.get("held_samples", []):
            b = int(t / bucket_s)
            per[b] = max(per.get(b, 0), held)
        for b, held in per.items():
            buckets[b] = buckets.get(b, 0) + held
    return max(buckets.values(), default=0)


def _run_fleet(routing_blob, chain_ids, args, wb_mode: str,
               namespace: str) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(i, routing_blob, chain_ids, vars(args),
                               wb_mode, namespace, q))
             for i in range(args.procs)]
    for p in procs:
        p.start()
    results = [q.get(timeout=600) for _ in procs]
    for p in procs:
        p.join(timeout=60)
        if p.exitcode != 0:
            raise RuntimeError(f"worker exited {p.exitcode}")
    lat_get = [x for r in results for x in r["lat_get"]]
    lat_put = [x for r in results for x in r["lat_put"]]
    hits = sum(r["hits"] for r in results)
    misses = sum(r["misses"] for r in results)
    elapsed = max(r["elapsed_s"] for r in results)
    gets = sum(r["gets"] for r in results)
    puts = sum(r["puts"] for r in results)
    return {
        "write_behind": wb_mode,
        "sessions": args.procs * args.sessions,
        "procs": args.procs,
        "hit_rate": round(hits / max(1, hits + misses), 4),
        "get_batches": gets, "puts": puts,
        "get_p50_ms": round(_pctl(lat_get, 0.50) * 1e3, 3),
        "get_p99_ms": round(_pctl(lat_get, 0.99) * 1e3, 3),
        "put_p50_ms": round(_pctl(lat_put, 0.50) * 1e3, 3),
        "put_p99_ms": round(_pctl(lat_put, 0.99) * 1e3, 3),
        "wall_s": round(elapsed, 2),
        "coalesced": sum(r["coalesced"] for r in results),
        "backpressure_waits": sum(r["backpressure"] for r in results),
        "adm_scope": results[0].get("adm_scope", "process"),
        "adm_waits": sum(r.get("adm_waits", 0) for r in results),
        "adm_host_peak": max(r.get("adm_host_peak", 0) for r in results),
        "adm_concurrent_held_peak": _concurrent_held_peak(results),
    }


def _run_admission_ab(routing_blob, chain_ids, args) -> dict:
    """Same fleet, admit_scope host vs process, small shared window.
    Host cell: ASSERT the arena never admitted past the host-wide
    window.  Process cell: measure how far N private windows over-admit
    (the N× cliff this plane removes)."""
    window = args.admit_window or 32
    out = {"window": window, "procs": args.procs}
    group = f"t3fs-fleet-{uuid.uuid4().hex[:12]}"
    for scope in ("host", "process"):
        cell_args = argparse.Namespace(**{
            **vars(args), "admit_window": window, "admit_scope": scope,
            "admit_group": group if scope == "host" else ""})
        ns = f"adm-{args.seed}-{scope}"
        cell = _run_fleet(routing_blob, chain_ids, cell_args, "on", ns)
        out[scope] = {
            "scope_effective": cell["adm_scope"],
            "host_peak": cell["adm_host_peak"],
            "concurrent_held_peak": cell["adm_concurrent_held_peak"],
            "waits": cell["adm_waits"],
            "put_p99_ms": cell["put_p99_ms"],
            "get_p99_ms": cell["get_p99_ms"],
        }
    try:
        from t3fs_torch.usrbio.slots import ShmTokenArena
        ShmTokenArena(group).unlink()
    except Exception:
        pass
    host = out["host"]
    # the tentpole's contract: N processes stay within ONE window
    out["bound_held"] = (host["scope_effective"] == "host"
                        and 0 < host["host_peak"] <= window)
    out["process_over_admitted"] = (
        out["process"]["concurrent_held_peak"] > window)
    out["over_admission_x"] = round(
        out["process"]["concurrent_held_peak"] / max(1, window), 2)
    if not out["bound_held"]:
        raise AssertionError(
            f"host-scope admission exceeded the host-wide bound: "
            f"peak {host['host_peak']} > window {window} "
            f"(scope_effective={host['scope_effective']})")
    return out


async def _gc_phase(fab, chain_ids, args, namespace: str) -> dict:
    """Evict the namespace to half its live bytes; removal IOPS."""
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.kvcache import (
        EvictionConfig, EvictionWorker, LedgerReader, LedgerTable,
        LedgerWriter,
    )
    from t3fs_torch.lib.kvcache import KVCacheConfig, KVCacheStore

    sc = StorageClient(lambda: fab.routing, client=fab.client)
    block_cap = 1 << (args.value_size + 256 - 1).bit_length()
    store = KVCacheStore(sc, chain_ids, namespace=namespace,
                         config=KVCacheConfig(block_size=block_cap))
    lanes = max(32, args.procs)
    reader = LedgerReader(store, lanes=lanes)
    table = LedgerTable()
    table.apply(await reader.scan())
    live = table.live_bytes
    writer = LedgerWriter(store, writer_id=10_000, lanes=lanes)
    await writer.attach()
    gc = EvictionWorker(store, reader, table, writer, EvictionConfig(
        byte_budget=max(1, live // 2), low_watermark=1.0,
        batch=args.gc_batch, remove_rate=1e9, remove_burst=1 << 20))
    keys_before = len(table)
    t0 = time.perf_counter()
    rep = await gc.run_pass()
    elapsed = time.perf_counter() - t0
    await sc.close()
    return {
        "live_keys_before": keys_before,
        "live_bytes_before": live,
        "live_bytes_after": table.live_bytes,
        "byte_budget": max(1, live // 2),
        "removed": rep["removed"],
        "gc_remove_iops": round(rep["removed"] / max(1e-9, elapsed), 1),
        "within_budget": table.live_bytes <= max(1, live // 2),
    }


async def run_bench(args) -> dict:
    from t3fs_torch.testing.fabric import StorageFabric

    fab = StorageFabric(num_nodes=args.nodes, replicas=args.replicas,
                        num_chains=args.chains,
                        write_pipeline="streamed",
                        checksum_backend="cpu" if args.cpu else "cuda")
    await fab.start()
    try:
        blob = freeze_routing(fab.routing)
        loop = asyncio.get_running_loop()
        out = {"fleet": {}}
        # interleave-free A/B would need two fabrics; fresh namespaces on
        # one fabric keep the chains identical for both sides instead
        for wb_mode in ("on", "off"):
            ns = f"fleet-{args.seed}-{wb_mode}"
            side = await loop.run_in_executor(
                None, _run_fleet, blob, fab.chain_ids, args, wb_mode, ns)
            out["fleet"][wb_mode] = side
            if wb_mode == "on":
                out["gc"] = await _gc_phase(fab, fab.chain_ids, args, ns)
        on, off = out["fleet"]["on"], out["fleet"]["off"]
        out["put_p50_speedup"] = round(
            off["put_p50_ms"] / max(1e-9, on["put_p50_ms"]), 2)
        if args.admission_ab:
            out["admission"] = await loop.run_in_executor(
                None, _run_admission_ab, blob, fab.chain_ids, args)
        return out
    finally:
        await fab.stop()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="kvcache_fleet_bench")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--sessions", type=int, default=256,
                    help="concurrent sessions per process")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--prompts", type=int, default=512,
                    help="distinct prompt templates (zipf popularity)")
    ap.add_argument("--blocks", type=int, default=8,
                    help="KV blocks per prompt prefix chain")
    ap.add_argument("--value-size", type=int, default=4 << 10)
    ap.add_argument("--zipf-alpha", type=float, default=1.1)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--gc-batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--admit-window", type=int, default=0,
                    help="namespace admission window (0 = sessions*2)")
    ap.add_argument("--admit-scope", choices=("process", "host"),
                    default="process")
    ap.add_argument("--admission-ab", action="store_true",
                    help="run the host-vs-process admission A/B and "
                         "assert the host-wide bound held")
    ap.add_argument("--cpu", action="store_true",
                    help="run the storage nodes' CRCs on the host backend")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card unless asked for the host: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    result = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(result))
    else:
        print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
