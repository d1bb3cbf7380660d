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

    python -m t3fs_torch.benchmarks.meta_bench --fuse --json   (kernel mount, root)

The port of benchmarks/meta_bench.py: the same phases, flags and JSON keys,
--fuse included (the phases as POSIX syscalls through the port's kernel
mount over an in-process cluster).  The in-process cluster's storage node
runs on the card's B1, or with --cpu on the host CRC (metadata ops touch no
chunk, so the phases are the same).
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


async def run_fuse_bench(args) -> dict:
    """The same phases as POSIX syscalls through a real kernel mount
    (mdtest proper).  Syscalls run on worker threads — they must never
    run on the daemon's event loop (fuse/kernel.py module docstring)."""
    import os
    import tempfile

    from t3fs_torch.fuse.kernel import FuseKernelMount
    from t3fs_torch.testing.cluster import LocalCluster

    cluster = LocalCluster(
        num_nodes=1, replicas=1, with_meta=True,
        checksum_backend="cpu" if getattr(args, "cpu", False) else "cuda")
    tmp = tempfile.mkdtemp(prefix="t3fs-metabench-")
    try:
        await cluster.start()
        mnt = os.path.join(tmp, "mnt")
        os.makedirs(mnt)
        fuse = FuseKernelMount(cluster.mc, cluster.sc, mnt)
        await fuse.mount()
    except BaseException:
        # a failed mount (non-root, no /dev/fuse) must not leak the
        # started cluster's tasks/sockets or the tmpdir
        await cluster.stop()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    D, F, C = args.dirs, args.files, args.concurrency
    out: dict = {"dirs": D, "files_per_dir": F, "concurrency": C,
                 "total_files": D * F, "path": "fuse-kernel-mount"}

    def _mk(p):
        os.mkdir(p)

    def _create(p):
        open(p, "w").close()

    def _stat(p):
        os.stat(p)

    def _list(p):
        os.listdir(p)

    def _rename(pair):
        os.rename(*pair)

    def _rm(p):
        os.remove(p)

    def _renamed(p):
        # rename only the BASENAME: a blanket p.replace("/f", "/r")
        # would also rewrite tmpdir components containing "/f"
        return os.path.join(os.path.dirname(p),
                            "r" + os.path.basename(p)[1:])

    # a dedicated executor sized to the requested concurrency:
    # asyncio.to_thread rides the default pool (cpu+4 threads — 5 on a
    # 1-CPU box), which would silently cap --concurrency 32 at 5
    # in-flight syscalls and mislabel the result
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=C, thread_name_prefix="mdtest")
    loop = asyncio.get_running_loop()

    def phase(fn, items):
        async def one(it):                 # lazy: starts under the sem,
            await loop.run_in_executor(pool, fn, it)  # inside the timer
        return _run_phase([one(it) for it in items], C)

    try:
        out["mkdir"] = await phase(
            _mk, [f"{mnt}/d{d:03d}" for d in range(D)])
        files = [f"{mnt}/d{d:03d}/f{f:04d}"
                 for d in range(D) for f in range(F)]
        out["create"] = await phase(_create, files)
        out["stat"] = await phase(_stat, files)
        out["list"] = await phase(
            _list, [f"{mnt}/d{d:03d}" for d in range(D)])
        out["rename"] = await phase(
            _rename, [(p, _renamed(p)) for p in files])
        out["remove"] = await phase(_rm, [_renamed(p) for p in files])
        return out
    finally:
        # wait for in-flight syscalls: unmounting under them races EBUSY
        # and would leak the mount + tmpdir on an error exit
        await asyncio.to_thread(pool.shutdown, wait=True,
                                cancel_futures=True)
        await fuse.unmount()
        await cluster.stop()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


async def run_bench(args) -> dict:
    if getattr(args, "fuse", False):
        if args.mgmtd:
            raise SystemExit(
                "--fuse benchmarks an in-process cluster's kernel mount; "
                "combining it with --mgmtd would silently measure the "
                "wrong cluster (mount against a live cluster with "
                "t3fs_torch.app.fuse_main and run mdtest on that mountpoint)")
        return await run_fuse_bench(args)
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
                    help="in-process cluster (--fuse too): the storage node checksums on "
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
