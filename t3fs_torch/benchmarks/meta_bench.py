"""meta_bench: metadata op-rate load generator (mdtest analog).

Reference role: 3FS's headline design bet is STATELESS metadata over a
transactional KV (SURVEY §1) — the meta service is a thin transaction
layer, so metadata throughput is the KV commit rate, horizontally
scalable.  The reference ships no in-repo metadata bench; mdtest-style
create/stat/list/remove phases are the industry-standard way to measure
this layer, and this harness drives them through the REAL MetaClient
(and therefore the real 2PC/SSI path on a sharded-KV deployment).

Phases (all ops/s, concurrency-C workers over D dirs x F files):
  mkdir    — directory tree creation
  create   — empty-file creates (the open(O_CREAT) hot path)
  stat     — path stat of every file (hot cache)
  batch    — batch_stat of F files per RPC (the readdirplus shape)
  list     — readdir of every directory
  rename   — rename every file within its dir
  remove   — unlink every file, then remove the tree

    python -m t3fs_torch.benchmarks.meta_bench --dirs 8 --files 64 --json
    python -m t3fs_torch.benchmarks.meta_bench --mgmtd HOST:PORT ...   (live cluster)

The port of benchmarks/meta_bench.py: the same phases, flags and JSON keys.
The in-process cluster's storage node runs on the card's B1, or with --cpu
on the host CRC (metadata ops touch no chunk, so the phases are the same).
--fuse needs fuse/kernel.py, not ported yet: it raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


async def _run_phase(coros: list, concurrency: int) -> dict:
    sem = asyncio.Semaphore(concurrency)
    t0 = time.perf_counter()

    async def one(c):
        async with sem:
            return await c

    await asyncio.gather(*[one(c) for c in coros])
    dt = time.perf_counter() - t0
    return {"ops": len(coros), "wall_s": round(dt, 3),
            "ops_s": round(len(coros) / dt, 1)}


async def run_bench(args) -> dict:
    if getattr(args, "fuse", False):
        if args.mgmtd:
            raise SystemExit(
                "--fuse benchmarks an in-process cluster's kernel mount; "
                "combining it with --mgmtd would silently measure the "
                "wrong cluster (mount against a live cluster with "
                "a fuse_main mount and run mdtest on that mountpoint)")
        raise NotImplementedError(
            "meta_bench --fuse drives a kernel mount through fuse/kernel.py, "
            "which is not ported yet (ROADMAP A12g)")
    if args.mgmtd:
        from t3fs_torch.benchmarks._env import make_meta_env
        mc, stop = await make_meta_env(args.mgmtd)
    else:
        from t3fs_torch.testing.cluster import LocalCluster
        cluster = LocalCluster(
            num_nodes=1, replicas=1, with_meta=True,
            checksum_backend="cpu" if getattr(args, "cpu", False) else "cuda")
        await cluster.start()
        mc = cluster.mc

        async def stop():
            await cluster.stop()

    D, F, C = args.dirs, args.files, args.concurrency
    root = f"/meta_bench_{int(time.time())}"
    out: dict = {"dirs": D, "files_per_dir": F, "concurrency": C,
                 "total_files": D * F}
    try:
        await mc.mkdirs(root)
        out["mkdir"] = await _run_phase([mc.mkdirs(f"{root}/d{d:03d}") for d in range(D)], C)
        out["create"] = await _run_phase([mc.create(f"{root}/d{d:03d}/f{f:04d}")
                       for d in range(D) for f in range(F)], C)
        out["stat"] = await _run_phase([mc.stat(f"{root}/d{d:03d}/f{f:04d}")
                     for d in range(D) for f in range(F)], C)
        out["batch_stat"] = await _run_phase([mc.batch_stat([f"{root}/d{d:03d}/f{f:04d}"
                                     for f in range(F)])
                      for d in range(D)], C)
        # batch phase counts RPCs above; report per-inode rate too
        out["batch_stat"]["inodes_s"] = round(
            out["batch_stat"]["ops_s"] * F, 1)
        out["list"] = await _run_phase([mc.readdir(f"{root}/d{d:03d}") for d in range(D)], C)
        out["rename"] = await _run_phase([mc.rename(f"{root}/d{d:03d}/f{f:04d}",
                                 f"{root}/d{d:03d}/r{f:04d}")
                       for d in range(D) for f in range(F)], C)
        out["remove"] = await _run_phase([mc.remove(f"{root}/d{d:03d}/r{f:04d}")
                       for d in range(D) for f in range(F)], C)
        await mc.remove(root, recursive=True)
    finally:
        await stop()
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="meta_bench")
    ap.add_argument("--mgmtd", default="",
                    help="live cluster address; omit for in-process")
    ap.add_argument("--fuse", action="store_true",
                    help="drive the phases through a REAL /dev/fuse "
                         "kernel mount (requires root) instead of the "
                         "meta RPC client — measures the full "
                         "syscall->kernel->daemon->meta path")
    ap.add_argument("--cpu", action="store_true",
                    help="in-process cluster: the storage node checksums on "
                         "the host CRC instead of the card's B1")
    ap.add_argument("--dirs", type=int, default=8)
    ap.add_argument("--files", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    result = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f"{k:>12}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
