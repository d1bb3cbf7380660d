"""storage_bench: direct StorageClient load generator.

Reference analog: benchmarks/storage_bench/ (StorageBench.cc:8-27) — drives
StorageClient against a cluster in write or read mode with checksum and
fault-injection flags; this is the harness behind the BASELINE configs.

Modes:
  --cluster local      in-process fabric (UnitTestFabric analog), default
  --mgmtd HOST:PORT    a live cluster (its mgmtd address)

    python -m t3fs_torch.benchmarks.storage_bench --mode write --chunk-size 1048576 \
        --num-chunks 64 --concurrency 16 --seconds 5 --json

The port of benchmarks/storage_bench.py, with the same arguments, defaults
and JSON keys wherever no device is involved.  The in-process fabric's
nodes checksum on the CUDA backend (--checksum-backend cuda, the default:
payloads of 64 KiB and more on the card, smaller ones on the host, as in
the reference) and its warm-up runs before the timed window; without a GPU
the bench raises.  --checksum-backend cpu (or --cpu) runs every CRC on the
host, config #1's CPU baseline; --device is accepted and names the default.
The fixed-op probes (run_write_bench, the write-pipeline, tracing and
read-hedging A/Bs) take the same backend.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time

from t3fs_torch import resolve_device
from t3fs_torch.client.storage_client import StorageClientConfig
from t3fs_torch.storage.types import ChunkId
from t3fs_torch.utils.metrics import LatencyRecorder
from t3fs_torch.utils.status import StatusCode

BENCH_INODE = 0xBE7C


_SELECTION = {"load_balance": 0, "round_robin": 1, "head": 2, "tail": 3,
              "adaptive": 4}   # TargetSelection by CLI name
# --checksum-backend names that put the nodes' CRCs on the card
DEVICE_BACKENDS = ("cuda", "gpu", "device", "tpu")


async def run_bench(args) -> dict:
    from t3fs_torch.benchmarks._env import make_env
    from t3fs_torch.client.storage_client import TargetSelection
    from t3fs_torch.utils.fault_injection import DebugFlags
    env, sc, chains = await make_env(args, StorageClientConfig(
        verify_checksums=args.verify_checksums,
        read_selection=TargetSelection(
            _SELECTION[getattr(args, "read_selection", "load_balance")]),
        read_hedging=getattr(args, "read_hedging", "off"),
        debug=DebugFlags(inject_server_error_prob=args.inject_server_error)))
    chain_id = chains[0]
    lat = LatencyRecorder("bench.op")
    stop_at = 0.0  # set after warmup, just before the timed phase
    counters = {"ops": 0, "bytes": 0, "errors": 0}
    payloads = [os.urandom(args.chunk_size) for _ in range(8)]

    async def writer(widx: int) -> None:
        i = widx
        while time.perf_counter() < stop_at:
            cid = ChunkId(BENCH_INODE, i % args.num_chunks)
            i += args.concurrency
            try:
                with lat.time():
                    res = await sc.write_chunk(chain_id, cid, 0,
                                               payloads[i % len(payloads)],
                                               args.chunk_size)
                if res.status.code != int(StatusCode.OK):
                    counters["errors"] += 1
                    continue
                counters["ops"] += 1
                counters["bytes"] += args.chunk_size
            except Exception:
                counters["errors"] += 1

    async def reader(widx: int) -> None:
        from t3fs_torch.storage.types import ReadIO
        i = widx
        while time.perf_counter() < stop_at:
            try:
                if args.batch > 1:
                    # KVCache-style batched random reads (the reference
                    # issues many IOs per RPC via USRBIO rings / batchRead)
                    ios = []
                    for _ in range(args.batch):
                        ios.append(ReadIO(
                            chunk_id=ChunkId(BENCH_INODE,
                                             i % args.num_chunks),
                            chain_id=chain_id))
                        i += args.concurrency
                    with lat.time():
                        results, datas = await sc.batch_read(ios)
                    ok = sum(1 for r in results
                             if r.status.code == int(StatusCode.OK))
                    counters["ops"] += ok
                    counters["errors"] += len(ios) - ok
                    counters["bytes"] += sum(len(d) for d in datas)
                else:
                    cid = ChunkId(BENCH_INODE, i % args.num_chunks)
                    i += args.concurrency
                    with lat.time():
                        _res, data = await sc.read_chunk(chain_id, cid)
                    counters["ops"] += 1
                    counters["bytes"] += len(data)
            except Exception:
                counters["errors"] += 1

    # warm the codec path (device backends compile per shape bucket; the
    # persistent cache makes this a one-time cost per machine) and populate
    # the keyspace for read mode
    if args.checksum_backend in DEVICE_BACKENDS and not args.mgmtd:
        for node in env.nodes:
            if hasattr(node.codec, "warmup"):
                await asyncio.to_thread(node.codec.warmup, [args.chunk_size])
    # read/mixed need the FULL keyspace populated (readers address
    # i % num_chunks); write mode just needs enough to warm the path
    n_pop = (args.num_chunks if args.mode in ("read", "mixed")
             else min(args.num_chunks, 2 * args.concurrency))
    populated = await asyncio.gather(*[
        sc.write_chunk(chain_id, ChunkId(BENCH_INODE, i), 0,
                       payloads[i % len(payloads)], args.chunk_size)
        for i in range(n_pop)])
    counters["errors"] += sum(r.status.code != int(StatusCode.OK)
                              for r in populated)

    t0 = time.perf_counter()
    stop_at = t0 + args.seconds
    worker = {"write": writer, "read": reader}.get(args.mode)
    if worker is not None:
        await asyncio.gather(*[worker(w) for w in range(args.concurrency)])
    else:  # mixed
        half = max(1, args.concurrency // 2)
        await asyncio.gather(*[writer(w) for w in range(half)],
                             *[reader(w) for w in range(half)])
    wall = time.perf_counter() - t0

    snap = lat.collect()
    result = {
        "mode": args.mode, "chunk_size": args.chunk_size,
        "write_pipeline": getattr(args, "write_pipeline", "off"),
        "concurrency": args.concurrency, "wall_s": round(wall, 3),
        "ops": counters["ops"], "errors": counters["errors"],
        "iops": round(counters["ops"] / wall, 1),
        "MB_s": round(counters["bytes"] / wall / 1e6, 2),
        "p50_ms": round(snap.get("p50", 0) * 1e3, 3),
        "p99_ms": round(snap.get("p99", 0) * 1e3, 3),
    }

    await sc.close()
    await env.stop()
    return result


def run_write_bench(value_size: int, num_ops: int, concurrency: int = 1,
                    replicas: int = 3, write_pipeline: str = "off",
                    stream_threshold: int | None = None,
                    checksum_backend=None) -> dict:
    """Fixed-op chain-write latency probe (the `make write-bench` A/B and
    the CI streamed-path smoke): `num_ops` writes of `value_size` through a
    `replicas`-deep chain, per-op latencies recorded.  Unlike run_bench's
    throughput loop this is latency-bound by construction — concurrency 1
    measures exactly the hop-serialization the write pipeline attacks.
    The nodes checksum on `checksum_backend` (the fabric's default, the
    card, when None)."""
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.testing.fabric import StorageFabric
    from t3fs_torch.utils.metrics import LatencyRecorder

    async def body() -> dict:
        fab = StorageFabric(num_nodes=max(3, replicas), replicas=replicas,
                            write_pipeline=write_pipeline,
                            stream_threshold=stream_threshold,
                            checksum_backend=checksum_backend)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        lat = LatencyRecorder("bench.write")
        counters = {"ok": 0, "errors": 0}
        payloads = [os.urandom(value_size) for _ in range(4)]
        try:
            # warm the path (conn setup, first-chunk alloc) off the clock
            res = await sc.write_chunk(fab.chain_id, ChunkId(BENCH_INODE, 0),
                                       0, payloads[0], value_size)
            if res.status.code != int(StatusCode.OK):
                counters["errors"] += 1

            async def worker(widx: int) -> None:
                for i in range(widx, num_ops, concurrency):
                    cid = ChunkId(BENCH_INODE, 1 + i)
                    try:
                        with lat.time():
                            res = await sc.write_chunk(
                                fab.chain_id, cid, 0,
                                payloads[i % len(payloads)], value_size)
                        if res.status.code != int(StatusCode.OK):
                            counters["errors"] += 1
                            continue
                        counters["ok"] += 1
                    except Exception:
                        counters["errors"] += 1

            t0 = time.perf_counter()
            await asyncio.gather(*[worker(w) for w in range(concurrency)])
            wall = time.perf_counter() - t0
        finally:
            await sc.close()
            await fab.stop()
        snap = lat.collect()
        return {
            "write_pipeline": write_pipeline, "value_size": value_size,
            "num_ops": num_ops, "concurrency": concurrency,
            "replicas": replicas, "ok": counters["ok"],
            "errors": counters["errors"], "wall_s": round(wall, 3),
            "p50_ms": round(snap.get("p50", 0) * 1e3, 3),
            "p99_ms": round(snap.get("p99", 0) * 1e3, 3),
        }

    return asyncio.run(body())


def write_pipeline_ab(value_size: int = 4 << 20, num_ops: int = 16,
                      replicas: int = 3, checksum_backend=None) -> dict:
    """The write-pipeline acceptance matrix: p50 of 4 MiB `replicas`-chain
    writes at concurrency 1, one entry per write_pipeline mode."""
    out = {}
    for mode in ("off", "overlap", "streamed"):
        out[mode] = run_write_bench(value_size, num_ops, concurrency=1,
                                    replicas=replicas, write_pipeline=mode,
                                    checksum_backend=checksum_backend)
    base = out["off"]["p50_ms"] or 1.0
    for mode in ("overlap", "streamed"):
        out[mode]["p50_vs_off"] = round(out[mode]["p50_ms"] / base, 3)
    return out


def trace_ab(value_size: int = 1 << 20, num_ops: int = 24,
             replicas: int = 3, checksum_backend=None) -> dict:
    """Distributed-tracing overhead on the chain
    write p50 at head sampling off / 1% / 100% (export=tail, the
    production shape — spans buffer and expire, nothing exports on a
    clean run).  The 1% column is the always-on production rate and must
    stay under a few percent of the off column."""
    from t3fs_torch.utils import tracing

    out = {}
    for label, rate in (("off", 0.0), ("rate_0.01", 0.01),
                        ("rate_1.0", 1.0)):
        tracing.configure(tracing.TraceConfig(sample_rate=rate))
        try:
            out[label] = run_write_bench(value_size, num_ops,
                                         concurrency=1, replicas=replicas,
                                         checksum_backend=checksum_backend)
        finally:
            tracing.reset_tracing()
        out[label]["sample_rate"] = rate
    base = out["off"]["p50_ms"] or 1.0
    for label in ("rate_0.01", "rate_1.0"):
        out[label]["p50_vs_off"] = round(out[label]["p50_ms"] / base, 3)
    return out


async def _read_bench_once(chunk_size: int, num_ops: int, *,
                           replicas: int = 3, read_hedging: str = "off",
                           read_selection: str = "load_balance",
                           straggler_delay_s: float = 0.0,
                           straggler_node: int = 0, batch: int = 4,
                           num_chunks: int = 64,
                           checksum_backend=None) -> dict:
    """Fixed-op batched-random-read latency probe against an in-process
    fabric with one optional injected-straggler node (the hedging shape:
    the read tail is the hot path, and hedging + adaptive selection attack
    exactly the straggler-induced p99).  Serial ops at `batch` IOs each —
    with load_balance over 3 replicas and batch=4, ~80% of ops touch the
    straggler, so its delay IS the unhedged p50/p99."""
    import random as _random

    from t3fs_torch.client.storage_client import StorageClient, TargetSelection
    from t3fs_torch.net.rpcstats import READ_STATS
    from t3fs_torch.storage.types import ReadIO
    from t3fs_torch.testing.fabric import StorageFabric
    from t3fs_torch.utils.metrics import LatencyRecorder

    READ_STATS.clear()   # fresh quantile state per run (bench hygiene)
    fab = StorageFabric(num_nodes=max(3, replicas), replicas=replicas,
                        checksum_backend=checksum_backend)
    await fab.start()
    sc = StorageClient(
        lambda: fab.routing, client=fab.client,
        config=StorageClientConfig(
            read_selection=TargetSelection(_SELECTION[read_selection]),
            read_hedging=read_hedging,
            hedge_delay_floor_s=0.005, hedge_delay_cap_s=0.1))
    lat = LatencyRecorder("bench.read")
    stats: dict = {}
    payload = os.urandom(chunk_size)
    try:
        await asyncio.gather(*[
            sc.write_chunk(fab.chain_id, ChunkId(BENCH_INODE, i), 0,
                           payload, chunk_size)
            for i in range(num_chunks)])
        fab.nodes[straggler_node].read_delay_s = straggler_delay_s
        rng = _random.Random(0xD1CE)
        t0 = time.perf_counter()
        for _ in range(num_ops):
            ios = [ReadIO(chunk_id=ChunkId(BENCH_INODE,
                                           rng.randrange(num_chunks)),
                          chain_id=fab.chain_id)
                   for _ in range(batch)]
            with lat.time():
                await sc.batch_read(ios, stats=stats)
        wall = time.perf_counter() - t0
    finally:
        fab.nodes[straggler_node].read_delay_s = 0.0
        await sc.close()
        await fab.stop()
    snap = lat.collect()
    fired = stats.get("hedge_fired", 0)
    return {
        "read_hedging": read_hedging, "read_selection": read_selection,
        "chunk_size": chunk_size, "num_ops": num_ops, "batch": batch,
        "replicas": replicas,
        "straggler_delay_ms": round(straggler_delay_s * 1e3, 3),
        "wall_s": round(wall, 3),
        "p50_ms": round(snap.get("p50", 0) * 1e3, 3),
        "p99_ms": round(snap.get("p99", 0) * 1e3, 3),
        "hedge_fired": fired,
        "hedge_won": stats.get("hedge_won", 0),
        "hedge_wasted": stats.get("hedge_wasted", 0),
        # per-IO hedge rate: the acceptance bound is the token-bucket
        # budget (pct * reads + burst)
        "hedge_rate": round(fired / max(1, num_ops * batch), 4),
    }


def run_read_bench(chunk_size: int, num_ops: int, **kw) -> dict:
    return asyncio.run(_read_bench_once(chunk_size, num_ops, **kw))


def read_hedging_ab(chunk_size: int = 64 << 10, num_ops: int = 120,
                    replicas: int = 3, straggler_delay_s: float = 0.01,
                    runs: int = 3, checksum_backend=None) -> dict:
    """The hedging acceptance A/B: the same random-read workload against a
    fabric with one injected 10ms-straggler node — off (load_balance, no
    hedging, today's path) vs on (adaptive selection + hedged reads).
    Interleaved off/on per docs/bench_protocol.md; quotes the median of
    `runs` with the run arrays recorded verbatim."""
    import statistics

    async def body() -> dict:
        off_runs, on_runs = [], []
        for _ in range(runs):
            off_runs.append(await _read_bench_once(
                chunk_size, num_ops, replicas=replicas,
                straggler_delay_s=straggler_delay_s,
                checksum_backend=checksum_backend))
            on_runs.append(await _read_bench_once(
                chunk_size, num_ops, replicas=replicas,
                read_hedging="on", read_selection="adaptive",
                straggler_delay_s=straggler_delay_s,
                checksum_backend=checksum_backend))

        def med(rs: list[dict], key: str):
            return round(statistics.median(r[key] for r in rs), 4)

        out = {}
        for mode, rs in (("off", off_runs), ("on", on_runs)):
            out[mode] = {
                "read_hedging": rs[0]["read_hedging"],
                "read_selection": rs[0]["read_selection"],
                "p50_ms": med(rs, "p50_ms"), "p99_ms": med(rs, "p99_ms"),
                "hedge_fired": med(rs, "hedge_fired"),
                "hedge_won": med(rs, "hedge_won"),
                "hedge_wasted": med(rs, "hedge_wasted"),
                "hedge_rate": med(rs, "hedge_rate"),
                "runs_p50_ms": [r["p50_ms"] for r in rs],
                "runs_p99_ms": [r["p99_ms"] for r in rs],
            }
        out["config"] = {"chunk_size": chunk_size, "num_ops": num_ops,
                         "batch": off_runs[0]["batch"],
                         "replicas": replicas, "runs": runs,
                         "straggler_delay_ms": round(straggler_delay_s * 1e3,
                                                     3)}
        base = out["off"]["p99_ms"] or 1.0
        out["p99_on_vs_off"] = round(out["on"]["p99_ms"] / base, 3)
        return out

    return asyncio.run(body())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="storage_bench")
    ap.add_argument("--mode", choices=["write", "read", "mixed"],
                    default="write")
    ap.add_argument("--mgmtd", default="",
                    help="live cluster address; omit for in-process fabric")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--chunk-size", type=int, default=1 << 20)
    ap.add_argument("--num-chunks", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1,
                    help="IOs per batch_read RPC in read mode (KVCache-style)")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--verify-checksums", action="store_true")
    ap.add_argument("--no-aio", action="store_true",
                    help="disable the io_uring read pipeline (A/B)")
    ap.add_argument("--checksum-backend", default="cuda",
                    choices=["cpu", *DEVICE_BACKENDS, "null"],
                    help="server-side codec seam (local cluster mode); "
                         "cuda, gpu, device and tpu all name the card")
    ap.add_argument("--inject-server-error", type=float, default=0.0,
                    help="probability of injected server errors (DebugFlags)")
    ap.add_argument("--write-pipeline", dest="write_pipeline",
                    choices=["off", "overlap", "streamed"], default="off",
                    help="chain write pipelining A/B (local cluster mode)")
    ap.add_argument("--stream-threshold", dest="stream_threshold",
                    type=int, default=None,
                    help="streamed-mode fragment threshold override (bytes)")
    ap.add_argument("--write-ab", dest="write_ab", action="store_true",
                    help="run the write-pipeline A/B matrix "
                         "(off/overlap/streamed) and print one JSON line")
    ap.add_argument("--num-ops", dest="num_ops", type=int, default=16,
                    help="fixed op count for --write-ab / --read-ab")
    ap.add_argument("--read-hedging", dest="read_hedging",
                    choices=["off", "on"], default="off",
                    help="hedged batch reads (off is byte-for-byte the "
                         "plain read path)")
    ap.add_argument("--read-selection", dest="read_selection",
                    choices=sorted(_SELECTION), default="load_balance",
                    help="read replica selection policy")
    ap.add_argument("--read-ab", dest="read_ab", action="store_true",
                    help="run the hedged-vs-off read A/B under an "
                         "injected straggler and print one JSON line")
    ap.add_argument("--trace-ab", dest="trace_ab", action="store_true",
                    help="run the tracing-overhead A/B (head sampling "
                         "off / 1%% / 100%%) and print one JSON line")
    ap.add_argument("--straggler-delay-ms", dest="straggler_delay_ms",
                    type=float, default=10.0,
                    help="injected per-read delay on one node for "
                         "--read-ab")
    ap.add_argument("--cpu", action="store_true",
                    help="run every node's CRC on the host backend "
                         "(--checksum-backend cpu)")
    ap.add_argument("--device", action="store_true",
                    help="the card (the default)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu:
        args.checksum_backend = "cpu"
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.checksum_backend in DEVICE_BACKENDS and not args.mgmtd:
        # the card unless asked for the host: raises where no GPU is present
        resolve_device("cuda")
    if args.write_ab:
        print(json.dumps(write_pipeline_ab(
            value_size=args.chunk_size, num_ops=args.num_ops,
            replicas=args.replicas, checksum_backend=args.checksum_backend)))
        return
    if args.trace_ab:
        print(json.dumps(trace_ab(
            value_size=args.chunk_size, num_ops=args.num_ops,
            replicas=args.replicas, checksum_backend=args.checksum_backend)))
        return
    if args.read_ab:
        print(json.dumps(read_hedging_ab(
            chunk_size=args.chunk_size, num_ops=args.num_ops,
            replicas=args.replicas,
            straggler_delay_s=args.straggler_delay_ms / 1e3,
            checksum_backend=args.checksum_backend)))
        return
    result = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(result))
    else:
        print(f"{result['mode']}: {result['MB_s']} MB/s, "
              f"{result['iops']} IOPS, p50={result['p50_ms']} ms, "
              f"p99={result['p99_ms']} ms, errors={result['errors']}")


if __name__ == "__main__":
    main()
