"""usrbio_bench: small-IO random reads through the USRBIO shm ring.

Reference analog: benchmarks/fio_usrbio/ — the fio external ioengine over
the hf3fs USRBIO C API, used to benchmark the KVCache-style random-read
path (README.md:45-48: peak ~40 GiB/s aggregate).  Here the app side preps
4 KiB random reads into the shared ring with a bounded queue depth and
measures completion IOPS + per-IO latency while the daemon-side RingWorker
drains through the StorageClient — via the rpc batch path or the
registered-arena ring data plane (--data-plane ring, docs/usrbio.md).

    python -m t3fs_torch.benchmarks.usrbio_bench --block-size 4096 --depth 64 \
        --seconds 5 --json
    python -m t3fs_torch.benchmarks.usrbio_bench --data-plane-ab --seconds 5 --json

--cross-host disables the shm alias (ring_no_shm), so every ring payload
rides the batched one-sided Buf.batch plane over real TCP — the
cross-host transport, measured on a same-host pair.  --cross-host-ab
runs the cross-host matrix: same-host shm cell, cross-host batched cell,
and cross-host per-op cell (ONE_SIDED_BATCH kill switch), reporting the
batched/shm and batched/per-op IOPS ratios.

    python -m t3fs_torch.benchmarks.usrbio_bench --cross-host-ab --seconds 5 --json

The port of benchmarks/usrbio_bench.py, with the same arguments, defaults
and JSON keys, and these additions.  The cluster's nodes checksum on the
CUDA backend (payloads of 64 KiB and more on the card); without a GPU the
bench raises, and --cpu runs every node's CRC on the host backend.
--verify holds every completed read against the populated bytes (counted
in "wrong_reads"); the populate writes POPULATE_CHUNKS chunks a call (one
call in the reference) and "populate_s" is its wall; --seed populates from numpy's generator instead of
os.urandom.  Each result also carries "ring": the SQEs the nodes' ring_rw
took by op, the populate's chunk writes, each ring session's `aliased`
bit, the addresses memoized as pre-ring, whether the client's ring plane
failed to start, the SQEs the clients sent and the IOs they spilled to
rpc: what shows that every IO rode the plane asked for.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import random
import sys
import time

import numpy as np

from t3fs_torch import resolve_device
from t3fs_torch.fuse.ring_worker import RingWorker
from t3fs_torch.fuse.vfs import FileSystem
from t3fs_torch.lib import usrbio
from t3fs_torch.net import rdma
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.usrbio import SlotAllocator


# chunk writes a populate call starts at once
POPULATE_CHUNKS = 256


def ring_facts(cluster, worker, populate_writes: int) -> dict:
    """What rode the ring in one run: the nodes' ring SQEs by op, the SQEs
    the clients' ring planes sent (the client's staging plane and the
    worker's lean plane; retries included) and the IOs they spilled to
    rpc, the populate's chunk writes, every ring session's aliased bit,
    the addresses memoized as pre-ring and whether the client's ring plane
    failed."""
    nodes = [ss.node for ss in cluster.storage.values()]
    planes = [p for p in (cluster.sc._ring_state["ring"],  # noqa: SLF001
                          worker._ring_plane if worker else None)  # noqa: SLF001
              if p is not None]
    return {
        "sqe_reads": sum(n.ring_reads for n in nodes),
        "sqe_writes": sum(n.ring_writes for n in nodes),
        "sent_reads": sum(p.sqes["read"] for p in planes),
        "sent_writes": sum(p.sqes["write"] for p in planes),
        "spills": sum(p.spills for p in planes),
        "populate_writes": populate_writes,
        "aliased": [a for p in planes for _, _, a in p._sessions.values()],  # noqa: SLF001
        "pre_ring": sum(len(p._no_ring) for p in planes),  # noqa: SLF001
        "failed": cluster.sc._ring_state["failed"],  # noqa: SLF001
    }


async def run_bench(args, after=None) -> dict:
    """One run on a fresh cluster.  `after`, if given, is awaited as
    after(cluster, fs, fh, iov, ring, ident, blob) once the timed reads
    are done and before teardown (chip_smoke.py's checks of the stored
    chunks ride it)."""
    # the file's bytes before the cluster starts: making hundreds of MiB
    # would stall its event loop past the nodes' 0.3 s self-fence
    blob = (os.urandom(args.file_size) if args.seed is None else
            np.random.default_rng(args.seed).bytes(args.file_size))
    cluster = LocalCluster(num_nodes=args.nodes, replicas=args.replicas,
                           num_chains=args.chains, with_meta=True,
                           checksum_backend=args.checksum_backend)
    await cluster.start()
    suffix = f"bench-{os.getpid()}-{random.getrandbits(24):06x}"
    iov = ring = worker = None
    try:
        # data plane selection happens BEFORE the RingWorker opens the
        # ring: the worker builds its lean ring path off storage.cfg
        cluster.sc.cfg.data_plane = args.data_plane
        if getattr(args, "cross_host", False):
            # withhold the shm alias: the server can never memcpy, so
            # every ring payload rides the batched one-sided plane —
            # the cross-host transport, forced on a same-host pair
            cluster.sc.cfg.ring_no_shm = True
        batch_before = rdma.BATCH_STATS.snapshot()
        fs = FileSystem(cluster.mc, cluster.sc)
        await fs.mkdirs("/bench")
        fh = await fs.create("/bench/data", chunk_size=args.block_size)
        file_blocks = args.file_size // args.block_size
        # populate through the normal write path, POPULATE_CHUNKS chunk
        # writes a call: write_file_range starts every chunk's write in one
        # loop iteration, and thousands of them stall the loop toward the
        # nodes' self-fence
        t_pop = time.perf_counter()
        step = POPULATE_CHUNKS * args.block_size
        for off in range(0, args.file_size, step):
            await fs.write(fh, off, blob[off:off + step])
        populate_s = time.perf_counter() - t_pop
        populate_writes = -(-args.file_size // args.block_size)

        iov = usrbio.IoVec(f"iov-{suffix}",
                           args.depth * args.block_size)
        ring = usrbio.IoRing(f"ring-{suffix}", entries=args.depth * 2,
                             iov=iov)
        ident = usrbio.reg_fd(fh)
        worker = RingWorker(f"ring-{suffix}", cluster.mc, cluster.sc)
        await worker.start()

        rng = random.Random(0)
        # pre-draw the random offsets: the harness tax inside the timed
        # loop should be the ring API, not the PRNG (both planes pay the
        # loop, so any fat here dilutes the A/B contrast)
        OMASK = (1 << 15) - 1
        offs = [rng.randrange(file_blocks) * args.block_size
                for _ in range(OMASK + 1)]
        oi = 0
        stop_at = time.perf_counter() + args.seconds
        completed = 0
        errors = 0
        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()
        inflight = 0
        userdata = 0
        # iov slot discipline via the shared allocator (t3fs/usrbio/
        # slots.py): a slot stays bound to its userdata until THAT IO
        # completes — deriving it from userdata % depth hands a live IO's
        # slot to a new one after out-of-order completions (torn reads)
        alloc = SlotAllocator(args.depth, args.block_size)
        issued_at: dict[int, float] = {}
        lat_s: list[float] = []
        file_off: dict[int, int] = {}
        wrong = 0
        while time.perf_counter() < stop_at or inflight:
            # top up the queue depth; one clock stamp covers the whole
            # top-up burst (sub-100us — noise at ms-scale percentiles)
            now = time.perf_counter()
            while alloc.available and now < stop_at:
                slot = alloc.acquire()
                alloc.bind(userdata, slot)
                ring.prep_io(True, ident, alloc.offset(slot),
                             args.block_size, offs[oi & OMASK],
                             userdata=userdata)
                if args.verify:
                    file_off[userdata] = offs[oi & OMASK]
                oi += 1
                issued_at[userdata] = now
                userdata += 1
                inflight += 1
            ring.submit_ios()
            done = await loop.run_in_executor(
                None, lambda: ring.wait_for_ios(
                    max_n=args.depth, min_n=1, timeout_ms=5000))
            if not done:
                break
            now = time.perf_counter()
            for c in done:
                inflight -= 1
                completed += 1
                slot = alloc.release_key(c.userdata)
                if args.verify:
                    off = file_off.pop(c.userdata)
                    if iov.read_at(alloc.offset(slot), args.block_size) != \
                            blob[off:off + args.block_size]:
                        wrong += 1
                lat_s.append(now - issued_at.pop(c.userdata))
                if c.status != 0:
                    errors += 1
        wall = time.perf_counter() - t0

        if after is not None:
            await after(cluster, fs, fh, iov, ring, ident, blob)
        await fs.close(fh)
        lat_s.sort()

        def pct(q: float) -> float:
            if not lat_s:
                return 0.0
            return lat_s[min(len(lat_s) - 1, int(q * len(lat_s)))]

        out = {
            "data_plane": args.data_plane,
            "block_size": args.block_size, "depth": args.depth,
            "file_size": args.file_size, "wall_s": round(wall, 3),
            "reads": completed, "errors": errors,
            "iops": round(completed / wall, 1),
            "MB_s": round(completed * args.block_size / wall / 1e6, 2),
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
            "populate_s": round(populate_s, 3),
            "ring": ring_facts(cluster, worker, populate_writes),
        }
        if args.verify:
            out["wrong_reads"] = wrong
        if getattr(args, "cross_host", False):
            ba, bb = rdma.BATCH_STATS.snapshot(), batch_before
            doorbells = ba["doorbells"] - bb["doorbells"]
            ops = ba["batched_ops"] - bb["batched_ops"]
            out["cross_host"] = True
            out["batched"] = rdma.ONE_SIDED_BATCH
            out["doorbells"] = doorbells
            out["batched_ops"] = ops
            out["fallback_ops"] = ba["fallback_ops"] - bb["fallback_ops"]
            out["ops_per_doorbell"] = round(ops / doorbells, 2) \
                if doorbells else 0.0
        return out
    finally:
        if worker:
            await worker.stop()
        if ring:
            ring.close()
        if iov:
            iov.close()
        await cluster.stop()


def run_ab(args) -> dict:
    """Ring-vs-rpc A/B: the same workload on two fresh clusters, one per
    data plane — each trial in its OWN event loop (asyncio.run cancels
    run 1's straggler tasks at loop close, so run 2 never pays for them)
    with a GC barrier between, so neither run rides the other's arena
    sessions, warmed caches, or heap garbage.  Each plane reports its
    MEDIAN-IOPS trial (all trial IOPS kept alongside): a single trial is
    hostage to episodic host noise, and a noise dip landing on either
    plane distorts the ratio in either direction."""
    out: dict = {}
    for plane in ("rpc", "ring"):
        args.data_plane = plane
        runs = []
        for _ in range(max(1, args.trials)):
            gc.collect()
            runs.append(asyncio.run(run_bench(args)))
        runs.sort(key=lambda r: r["iops"])
        out[plane] = runs[len(runs) // 2]
        if len(runs) > 1:
            out[plane]["trial_iops"] = [r["iops"] for r in runs]
    out["ring_vs_rpc_iops"] = round(
        out["ring"]["iops"] / max(out["rpc"]["iops"], 1e-9), 2)
    return out


def run_crosshost_ab(args) -> dict:
    """The cross-host matrix, same trial discipline as run_ab (fresh
    loop + fresh cluster per trial, GC barrier, median-IOPS trial):
      shm               ring plane, same-host shm alias
      crosshost_batched ring plane, no shm alias, Buf.batch transport
      crosshost_perop   ring plane, no shm alias, per-op Buf RPCs
                        (ONE_SIDED_BATCH kill switch: the pre-batch wire)
    The acceptance ratio is crosshost_batched vs shm (within 2x); the
    batched-vs-perop ratio is what the doorbell coalescing bought."""
    cells = (("shm", False, True),
             ("crosshost_batched", True, True),
             ("crosshost_perop", True, False))
    out: dict = {}
    batch_was = rdma.ONE_SIDED_BATCH
    try:
        for name, cross, batched in cells:
            args.data_plane = "ring"
            args.cross_host = cross
            rdma.ONE_SIDED_BATCH = batched
            runs = []
            for _ in range(max(1, args.trials)):
                gc.collect()
                runs.append(asyncio.run(run_bench(args)))
            runs.sort(key=lambda r: r["iops"])
            out[name] = runs[len(runs) // 2]
            if len(runs) > 1:
                out[name]["trial_iops"] = [r["iops"] for r in runs]
    finally:
        rdma.ONE_SIDED_BATCH = batch_was
        args.cross_host = False
    out["crosshost_batched_vs_shm_iops"] = round(
        out["crosshost_batched"]["iops"] / max(out["shm"]["iops"], 1e-9), 3)
    out["batched_vs_perop_iops"] = round(
        out["crosshost_batched"]["iops"]
        / max(out["crosshost_perop"]["iops"], 1e-9), 3)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="usrbio_bench")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--file-size", type=int, default=4 << 20)
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--data-plane", choices=("rpc", "ring"), default="rpc")
    ap.add_argument("--cross-host", action="store_true",
                    help="disable the shm alias (ring_no_shm): every ring "
                         "payload rides the batched one-sided transport")
    ap.add_argument("--data-plane-ab", action="store_true",
                    help="run BOTH data planes and report the IOPS ratio")
    ap.add_argument("--cross-host-ab", action="store_true",
                    help="run the shm / cross-host-batched / cross-host-"
                         "per-op matrix and report the IOPS ratios")
    ap.add_argument("--trials", type=int, default=3,
                    help="A/B trials per plane; the median-IOPS trial is "
                         "reported (only --data-plane-ab uses this)")
    ap.add_argument("--verify", action="store_true",
                    help="hold every completed read against the populated "
                         "bytes (counted in wrong_reads)")
    ap.add_argument("--seed", type=int, default=None,
                    help="populate from numpy's generator at this seed "
                         "instead of os.urandom")
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
    if args.cross_host_ab:
        result = run_crosshost_ab(args)
        if args.json:
            print(json.dumps(result))
        else:
            for cell in ("shm", "crosshost_batched", "crosshost_perop"):
                r = result[cell]
                extra = (f", {r.get('ops_per_doorbell', 0)} ops/doorbell"
                         if r.get("cross_host") else "")
                print(f"{cell:>17}: {r['iops']} IOPS, p50 {r['p50_ms']} ms, "
                      f"p99 {r['p99_ms']} ms, errors={r['errors']}{extra}")
            print(f"crosshost-batched/shm IOPS: "
                  f"{result['crosshost_batched_vs_shm_iops']}x  "
                  f"batched/per-op IOPS: {result['batched_vs_perop_iops']}x")
        return 0
    if args.data_plane_ab:
        result = run_ab(args)
        if args.json:
            print(json.dumps(result))
        else:
            for plane in ("rpc", "ring"):
                r = result[plane]
                print(f"{plane:>4}: {r['iops']} IOPS, p50 {r['p50_ms']} ms, "
                      f"p99 {r['p99_ms']} ms, errors={r['errors']}")
            print(f"ring/rpc IOPS: {result['ring_vs_rpc_iops']}x")
        return 0
    result = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(result))
    else:
        print(f"randread {result['block_size']} B x depth {result['depth']} "
              f"[{result['data_plane']}]: {result['iops']} IOPS, "
              f"{result['MB_s']} MB/s, p50 {result['p50_ms']} ms, "
              f"p99 {result['p99_ms']} ms, errors={result['errors']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
