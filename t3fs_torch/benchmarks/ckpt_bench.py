"""Checkpoint engine bench: parallel pytree save / restore over the EC
stripe path (the paper's high-throughput-checkpointing workload).

Phases, each MB/s of logical (pre-parity) tree bytes:
  save      — CheckpointWriter.save: fused device encode+CRC, stripe
              window + per-chain admission fan-out, manifest commit
  restore   — CheckpointReader.restore: healthy path (read_file_ranges
              over the EC data layout), CRC-checked against the manifest
  degraded  — with --kill: restore after fail-stopping one storage node
              (reconstruct-verified reads mask its shards)

Protocol (docs/bench_protocol.md): every quoted value is the median of
--runs >= 3 fresh-cluster runs, the raw samples ride along in "runs";
single-shot numbers are drift, not evidence.

    python -m t3fs_torch.benchmarks.ckpt_bench --leaves 4 --leaf-mb 4 --json
    python -m t3fs_torch.benchmarks.ckpt_bench --kill --json

The port of benchmarks/ckpt_bench.py, with the same arguments, defaults and
JSON keys.  The one difference: the device is the default.  Every storage
node checksums on the CUDA backend and the EC client encodes on
TorchECCodec on the card; without a GPU the bench raises.  --cpu runs both
on their plain PyTorch versions on the host; --device is accepted and
changes nothing (it names the default).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import sys
import time

import numpy as np

from t3fs_torch import resolve_device
from t3fs_torch.ckpt import CheckpointReader, CheckpointWriter
from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.fuse.vfs import FileSystem
from t3fs_torch.testing.cluster import LocalCluster


def _make_tree(args, rng) -> dict:
    leaf_bytes = args.leaf_mb * (1 << 20)
    return {f"layer{i}": {"w": rng.integers(0, 256, leaf_bytes,
                                            dtype=np.uint8)}
            for i in range(args.leaves)}


async def _one_run(args) -> dict:
    """One fresh-cluster sample (bench_protocol rule 3: benches that
    reuse a live cluster read each other's chunks)."""
    k, m = args.k, args.m
    num_chains = k + m
    cluster = LocalCluster(num_nodes=args.nodes, replicas=1,
                           num_chains=num_chains, with_meta=True,
                           heartbeat_timeout_s=0.6,
                           checksum_backend="cpu" if args.cpu else "cuda")
    await cluster.start()
    try:
        lay = ECLayout.create(k=k, m=m, chunk_size=args.chunk_size,
                              chains=list(range(1, num_chains + 1)))
        ec = ECStorageClient(cluster.sc, codec=TorchECCodec(
            device="cpu" if args.cpu else "cuda"))
        fs = FileSystem(cluster.mc, cluster.sc)
        tree = _make_tree(args, np.random.default_rng(7))
        total = sum(leaf["w"].nbytes for leaf in tree.values())
        writer = CheckpointWriter(ec, fs, lay, "/bench/ckpt",
                                  window=args.window,
                                  per_chain=args.per_chain)

        t0 = time.perf_counter()
        stats = await writer.save(1, tree, resume=False)
        t_save = time.perf_counter() - t0

        reader = CheckpointReader(ec, fs, "/bench/ckpt",
                                  window=args.window)
        t0 = time.perf_counter()
        got = await reader.restore()
        t_restore = time.perf_counter() - t0
        for name, leaf in tree.items():
            assert np.array_equal(got[name]["w"], leaf["w"]), name

        sample = {
            "save_MB_s": total / t_save / 1e6,
            "restore_MB_s": total / t_restore / 1e6,
            "bytes": total,
            "stripes": stats.stripes_total,
        }

        if args.kill:
            victim = args.nodes   # last node; EC chains only, meta lives
            lost = [c.chain_id for c in  # on the LocalCluster meta node
                    cluster.mgmtd.state.routing().chains.values()
                    if any(t.node_id == victim for t in c.targets)]
            await cluster.kill_storage_node(victim)
            for _ in range(200):
                routing = cluster.mgmtd.state.routing()
                if all(routing.chains[c].chain_ver >= 2 for c in lost):
                    break
                await asyncio.sleep(0.05)
            else:
                raise TimeoutError("chains never noticed the node kill")
            await cluster.mgmtd_client.refresh()
            t0 = time.perf_counter()
            got = await reader.restore()
            t_degraded = time.perf_counter() - t0
            for name, leaf in tree.items():
                assert np.array_equal(got[name]["w"], leaf["w"]), name
            sample["degraded_restore_MB_s"] = total / t_degraded / 1e6

        if ec.codec is not None:
            sample["codec_counts"] = dict(ec.codec.codec_counts)
            await ec.close()
        return sample
    finally:
        await cluster.stop()


async def run_bench(args) -> dict:
    samples = [await _one_run(args) for _ in range(args.runs)]

    def med(key):
        vals = [s[key] for s in samples if key in s]
        return (round(statistics.median(vals), 2),
                [round(v, 2) for v in vals]) if vals else (None, [])

    save_med, save_runs = med("save_MB_s")
    restore_med, restore_runs = med("restore_MB_s")
    degraded_med, degraded_runs = med("degraded_restore_MB_s")
    result = {
        "k": args.k, "m": args.m, "chunk_size": args.chunk_size,
        "leaves": args.leaves, "leaf_mb": args.leaf_mb,
        "bytes": samples[0]["bytes"], "stripes": samples[0]["stripes"],
        "window": args.window, "per_chain": args.per_chain,
        "codec": "cpu" if args.cpu else "cuda",
        "codec_counts": samples[-1].get("codec_counts"),
        "save_MB_s": save_med, "save_runs": save_runs,
        "restore_MB_s": restore_med, "restore_runs": restore_runs,
        "verified": True,
    }
    if degraded_med is not None:
        result["degraded_restore_MB_s"] = degraded_med
        result["degraded_runs"] = degraded_runs
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="ckpt_bench")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, default=256 << 10)
    ap.add_argument("--leaves", type=int, default=4)
    ap.add_argument("--leaf-mb", type=int, default=4,
                    help="MiB per pytree leaf")
    ap.add_argument("--window", type=int, default=8,
                    help="stripes in flight")
    ap.add_argument("--per-chain", type=int, default=2,
                    help="chunk writes in flight per chain")
    ap.add_argument("--runs", type=int, default=3,
                    help="fresh-cluster samples per quoted median")
    ap.add_argument("--kill", action="store_true",
                    help="also time a degraded restore after a node kill")
    ap.add_argument("--device", action="store_true",
                    help="encode/CRC on the card (the default)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the codec and the nodes' CRCs on the plain "
                         "PyTorch versions on the host")
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
        for kk, v in result.items():
            print(f"{kk:>24}: {v}")
    # one-line scrapable metric, printed in BOTH output modes
    print(json.dumps({"ckpt_metric": {
        f"rs{args.k}+{args.m}_save_MB_s": result["save_MB_s"],
        "restore_MB_s": result["restore_MB_s"],
        "degraded_restore_MB_s": result.get("degraded_restore_MB_s"),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
