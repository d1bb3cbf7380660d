"""EC recovery bench — BASELINE config #4: RS(8+2) stripe writes, degraded
reads after a node loss, and shard repair (reconstruct + write back); then
the decode microbench on the card.

Phases (all timed separately, MB/s of logical stripe data):
  write     — RS(8+2)-encoded stripe writes across single-replica chains
  degraded  — full-stripe reads with one node fail-stopped (reconstruction
              masks its shards on the fly)
  repair    — reconstruct the dead node's shards and re-write them to the
              recovered chains (the resync-with-decode path)

    python3 -m t3fs_torch.benchmarks.ec_recovery_bench --stripes 24 --json
    python3 -m t3fs_torch.benchmarks.ec_recovery_bench --decode-ab \
        [--k 8 --m 2 --chunk-size 262144 --decode-batch 4 --json]

The port of benchmarks/ec_recovery_bench.py, with the same arguments,
defaults and JSON keys.  The cluster phases run on the port's LocalCluster
(every node's CRCs on the CUDA checksum backend) with an ECStorageClient
over TorchECCodec on the card: B2 + B1 on the writes, B3 + B1 on the
degraded reads, B4 + B1 (or B3 + B1) on the repairs.  --device is accepted
and names the default; --cpu runs the nodes' CRCs on the host and the codec
on its plain versions, and skips the microbench.  Without a GPU and without
--cpu the bench raises.

The decode microbench is kernel-level decode throughput on synthetic
survivors, no cluster IO in the way: shards 0 and 1 are lost, the first k
of shards 2.. are present.  For the RAID-6 code it times the fused word
decode+verify step (B3, then B1 on survivors and rebuilt shards;
`fused_decode_verify_GB_s`) and the word reconstruct alone (B3;
`word_reconstruct_GB_s`); with --decode-ab, or for any other code, the
byte-plane reconstruct (B5; `byteplane_reconstruct_GB_s`).  GB/s counts
survivor bytes in per launch (n*k*L), as the encode bench counts data
bytes; each time is the median of 5 CUDA-event samples of 20 launches.
The bench ends with a one-line JSON decode metric (the fused decode's GB/s
and the cluster's degraded-read MB/s).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
import traceback

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.benchmarks.devbench import card_line, median_ms
from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.mgmtd.placement import chain_recovery_weights
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusCode

WANT = (0, 1)                # the lost shards: a double erasure


async def run_bench(args) -> dict:
    k, m = args.k, args.m
    num_chains = k + m
    # one chain per shard slot, single replica: parity replaces replication
    cluster = LocalCluster(num_nodes=args.nodes, replicas=1,
                           num_chains=num_chains, heartbeat_timeout_s=0.6,
                           checksum_backend="cpu" if args.cpu else "cuda")
    await cluster.start()
    try:
        return await _run(args, cluster, k, m, num_chains)
    finally:
        await cluster.stop()


async def _run(args, cluster: LocalCluster, k: int, m: int,
               num_chains: int) -> dict:
    lay = ECLayout.create(k=k, m=m, chunk_size=args.chunk_size,
                          chains=list(range(1, num_chains + 1)))
    ec = ECStorageClient(cluster.sc, codec=TorchECCodec(
        device="cpu" if args.cpu else "cuda"))
    stripe_len = k * args.chunk_size
    rng = np.random.default_rng(11)
    payloads = [rng.integers(0, 256, stripe_len, dtype=np.uint8).tobytes()
                for _ in range(4)]
    inode = 0xEC0
    total = args.stripes * stripe_len

    # --- write ---
    t0 = time.perf_counter()
    for s0 in range(0, args.stripes, args.concurrency):
        batch = range(s0, min(s0 + args.concurrency, args.stripes))
        res = await asyncio.gather(*(
            ec.write_stripe(lay, inode, s, payloads[s % len(payloads)])
            for s in batch))
        for rs_ in res:
            assert all(r.status.code == int(StatusCode.OK) for r in rs_)
    t_write = time.perf_counter() - t0

    # --- fail-stop one node; wait for chains to notice ---
    victim = args.nodes  # last node
    lost_chains = [c.chain_id for c in
                   cluster.mgmtd.state.routing().chains.values()
                   if any(t.node_id == victim for t in c.targets)]
    await cluster.kill_storage_node(victim)
    for _ in range(200):
        routing = cluster.mgmtd.state.routing()
        if all(routing.chains[c].chain_ver >= 2 for c in lost_chains):
            break
        await asyncio.sleep(0.05)
    else:
        raise TimeoutError("chains never noticed the node kill — the "
                           "'degraded' phase would measure stale routing")
    await cluster.mgmtd_client.refresh()

    # --- degraded reads (reconstruction masks the dead node's shards) ---
    t0 = time.perf_counter()
    for s0 in range(0, args.stripes, args.concurrency):
        batch = range(s0, min(s0 + args.concurrency, args.stripes))
        datas = await asyncio.gather(*(
            ec.read_stripe(lay, inode, s, stripe_len) for s in batch))
        for s, d in zip(batch, datas):
            assert d == payloads[s % len(payloads)], f"stripe {s} corrupt"
    t_degraded = time.perf_counter() - t0

    # --- repair: rebuild the dead node's shards onto the (restarted)
    # chains.  Restart the node empty: chains walk back to SERVING and the
    # repair writes land on the fresh target — simulated chunk loss. ---
    import shutil
    shutil.rmtree(cluster.node_root(victim), ignore_errors=True)
    await cluster.start_storage_node(victim)
    for _ in range(300):
        routing = cluster.mgmtd.state.routing()
        if all(routing.chains[c].head() is not None for c in lost_chains):
            break
        await asyncio.sleep(0.05)
    else:
        raise TimeoutError("restarted node's chains never returned to "
                           "service — repair phase has nowhere to write")
    await cluster.mgmtd_client.refresh()

    stripe_losses = {
        s: tuple(j for j in range(k + m)
                 if lay.shard_chain(s, j) in lost_chains)
        for s in range(args.stripes)}
    n_shards = sum(len(v) for v in stripe_losses.values())
    t0 = time.perf_counter()
    # survivor-read-balanced scheduling (the BIBD objective): the planner
    # picks WHICH k survivors each stripe reads.  The placement weights
    # are wired for parity with real deployments, but in THIS replicas-1
    # topology they are inert: the weighted chains are exactly the lost
    # chains, which never appear as survivors — the measured imbalance
    # improvement comes from the k-subset pick alone
    from t3fs_torch.client.repair import RepairDriver, RepairJob
    weights = chain_recovery_weights(cluster.mgmtd.state.routing(),
                                     {victim})
    driver = RepairDriver(ec, concurrency=args.concurrency,
                          initial_load=weights)
    report = await driver.run([RepairJob(
        layout=lay, inode=inode,
        stripe_len_of={s: stripe_len for s in range(args.stripes)},
        losses=stripe_losses)])
    assert not report.failed, report.failed
    assert report.repaired_shards == n_shards
    t_repair = time.perf_counter() - t0
    repaired_bytes = n_shards * args.chunk_size

    # --- full (non-degraded) read-back proves the repair ---
    for s in range(args.stripes):
        d = await ec.read_stripe(lay, inode, s, stripe_len)
        assert d == payloads[s % len(payloads)], f"post-repair stripe {s}"

    # which codec implementation actually served the calls (cuda-* routes
    # on the card, cpu-* on the plain versions), plus batching effectiveness
    codec_stats = None
    if ec.codec is not None:
        codec_stats = {
            "counts": dict(ec.codec.codec_counts),
            "batches": ec.codec.batches,
            "batched_items": ec.codec.batched_items,
        }
        await ec.close()

    return {
        "k": k, "m": m, "chunk_size": args.chunk_size,
        "stripes": args.stripes, "bytes": total,
        "codec": "cpu" if args.cpu else "cuda",
        "codec_stats": codec_stats,
        "write_MB_s": round(total / t_write / 1e6, 2),
        "degraded_read_MB_s": round(total / t_degraded / 1e6, 2),
        "repaired_shards": n_shards,
        "repair_MB_s": round(repaired_bytes / t_repair / 1e6, 2),
        # IO accounting from RepairReport: survivor bytes pulled
        # per rebuilt byte — the number the reduced-read drill bench drives
        # below 0.5 with LRC locals (repair_drill_bench.py)
        "repair_bytes_read": report.bytes_read,
        "repair_bytes_repaired": report.bytes_repaired,
        "repair_stripes_failed": report.stripes_failed,
        "repair_read_amplification": round(
            report.bytes_read / max(report.bytes_repaired, 1), 3),
        # survivor-read balance achieved by the k-subset planner
        # (1.0 = perfectly flat)
        "survivor_read_imbalance": round(
            report.max_chain_reads / report.min_chain_reads, 3)
        if report.min_chain_reads else None,
        "survivor_reads_max_min": [report.max_chain_reads,
                                   report.min_chain_reads],
        "verified": True,
    }


def decode_pattern(k: int, m: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(present, want): the first k survivors of shards 2..k+m-1, and (0, 1).
    The reference lists all of 2..k+m-1, which is k shards only for m = 2."""
    return tuple(range(2, k + m))[:k], WANT


def decode_inputs(k: int, L: int, n: int) -> np.ndarray:
    """(n, k, L) uint8 survivors, from the reference's generator and seed."""
    return np.random.default_rng(7).integers(0, 256, (n, k, L), dtype=np.uint8)


def decode_ops(k: int, m: int, L: int, n: int, decode_ab: bool = True,
               device: str | torch.device = "cuda") -> dict:
    """name -> (op, input) of each timed decode, on `device`: the fused
    step and the word reconstruct for RAID-6, and the byte-plane
    reconstruct under decode_ab or for any other code."""
    dev = resolve_device(device)
    if L <= 0 or L % 512:
        raise ValueError(f"L={L}: the word step takes whole 512-byte segments")
    rs = default_rs(k, m)
    present, want = decode_pattern(k, m)
    survivors = torch.from_numpy(decode_inputs(k, L, n)).to(dev)
    ops = {}
    if rs.raid6:
        words = survivors.view(torch.int32)
        ops["fused_decode_verify_GB_s"] = (cc.make_stripe_decode_step_words(
            L // 4, present, want, k, m, dev), words)
        ops["word_reconstruct_GB_s"] = (
            cc.make_rs_reconstruct_words(present, want, rs, dev), words)
    if decode_ab or not rs.raid6:
        ops["byteplane_reconstruct_GB_s"] = (
            cc.make_rs_reconstruct_bytes(present, want, rs, dev), survivors)
    return ops


def decode_microbench(args, device: str | torch.device = "cuda") -> dict:
    """GB/s of survivor bytes of each decode op, at args.chunk_size cut to
    whole segments and args.decode_batch stripes a launch."""
    L = args.chunk_size - args.chunk_size % 512
    n = max(1, args.decode_batch)
    res: dict = {"L": L, "batch": n}
    for name, (op, x) in decode_ops(args.k, args.m, L, n, args.decode_ab,
                                    device).items():
        ms = median_ms(lambda op=op, x=x: op(x))
        res[name] = n * args.k * L / ms / 1e6
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="t3fs_torch.benchmarks.ec_recovery_bench")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, default=256 << 10)
    ap.add_argument("--stripes", type=int, default=16)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--device", action="store_true",
                    help="RS encode/decode on the card (the default)")
    ap.add_argument("--cpu", action="store_true",
                    help="the nodes' CRCs on the host, the codec on its plain "
                         "versions, no microbench")
    ap.add_argument("--decode-ab", action="store_true",
                    help="also time the byte-plane reconstruct kernel for the "
                         "word-vs-byte A/B")
    ap.add_argument("--decode-batch", type=int, default=4,
                    help="stripes per launch in the decode microbench")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The result record: the cluster phases, then (on the card) the card's
    name and the decode microbench."""
    resolve_device("cpu" if args.cpu else "cuda")
    result = asyncio.run(run_bench(args))
    if not args.cpu:
        result["device"] = torch.cuda.get_device_name(0)
        result["decode_microbench"] = decode_microbench(args)
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run(args)
        card = None if args.cpu else card_line()
    except Exception as e:      # the caller gets one JSON line whatever failed
        traceback.print_exc()
        print(json.dumps({"decode_metric": None, "error": f"{type(e).__name__}: {e}"}),
              flush=True)
        return 1
    if args.json:
        print(json.dumps(result))
    else:
        for key, v in result.items():
            print(f"{key:>20}: {v}")
    if card is not None:
        print(f"card: {card}")
    # one-line scrapable decode metric, printed in both output modes
    print(json.dumps({"decode_metric": {
        f"rs{args.k}+{args.m}_reconstruct_GB_s":
            result.get("decode_microbench", {}).get("fused_decode_verify_GB_s"),
        "degraded_read_MB_s": result["degraded_read_MB_s"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
