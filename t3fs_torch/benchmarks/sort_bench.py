"""GraySort-analog: two-phase partition sort with t3fs as the shuffle
medium, and the device key sort of its reduce phase measured alone.

The port of benchmarks/sort_bench.py.  Two modes:

The shuffle job (the reference's, with its flags, defaults and result keys):

    python3 -m t3fs_torch.benchmarks.sort_bench --mb 64 --partitions 8 \
        [--sort-backend device] [--cpu] [--json]

Phase 1 reads each worker's gensort input (10-byte key + 90-byte payload)
back from storage, range-partitions it by key and writes one run a
partition; phase 2 reads each partition's runs (lengths via
query_last_chunk), sorts them and writes the sorted output; the outputs are
then checked sorted, in order across partitions, and equal in count and
key XOR to the input.  Every byte crosses the storage stack four times,
through StorageClient file ranges over the in-process fabric (3 nodes, 1
replica) or a live cluster (--mgmtd).  The fabric's nodes checksum on the
CUDA backend (chunks of 64 KiB and more on the card) and `--sort-backend
device` sorts each partition's keys with make_device_sorter on the card;
without a GPU both raise.  --cpu runs the nodes' CRCs on the host backend
and the device sorter on the CPU (its plain PyTorch version).

The in-memory measurement of the device sort alone (chip_smoke's phase 18):

    python3 -m t3fs_torch.benchmarks.sort_bench (--records N | --quick)

sorts N rows in memory (--records N; chip_smoke's phase 18 measures 2^24,
one reduce partition of 1.68 GB) or 2^22 (--quick), made as the reference
makes worker 0's input:
default_rng(seed).integers(0, 256, (n, 100), uint8), seed 2026.  It
reports, on the card:

  sort_ms         the device sort alone (t3fs_torch/ops/device_sort.py
                  sort_columns: two stable torch.sorts and the gather), the
                  median of 5 CUDA-event samples of 20 calls; records/s
                  and key MB/s (10-byte keys) from it; bound_ms, the key
                  columns read (3 x int64) and the int32 permutation
                  written once, at 3.35 TB/s
  h2d_ms, d2h_ms  the copy of the three int64 columns to the card and of
                  the permutation back, timed the same way
  host_columns_ms the host's key-column extraction, host clock
  gather_ms       the host gather of the 100-byte rows by the permutation
  lexsort_ms      np.lexsort on the same rows (lexsort_rows), host clock
  sorter_wall_ms  make_device_sorter's whole call (columns, H2D, sort, D2H),
                  host clock

The permutation is checked against lexsort_rows, then one JSON line is
printed with the card.  This mode always runs on the card: without a GPU it
raises, and it takes no --cpu.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.benchmarks.devbench import card_line, median_ms
from t3fs_torch.client.layout import FileLayout
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.ops.device_sort import (
    KEY_LEN, REC_LEN, host_columns, lexsort_rows, make_device_sorter, sort_columns)
from t3fs_torch.utils.status import StatusCode

SEED = 2026
QUICK_RECORDS = 1 << 22
HBM_BYTES_PER_S = 3.35e12


def gensort_rows(n: int, seed: int = SEED) -> np.ndarray:
    """Worker 0's input rows of the reference job: (n, 100) uint8."""
    return np.random.default_rng(seed).integers(0, 256, (n, REC_LEN), dtype=np.uint8)


def measure(rows: np.ndarray) -> dict:
    """The bench on (n, 100) uint8 rows on the card (see the module's
    docstring); both the timed sort and make_device_sorter's whole path
    (columns, H2D, sort, D2H; `sorter_wall_ms`, host clock) must give
    lexsort_rows' permutation."""
    dev = resolve_device("cuda")
    n = len(rows)
    t0 = time.perf_counter()
    host = host_columns(rows)
    host_columns_ms = (time.perf_counter() - t0) * 1e3
    cols = [torch.from_numpy(c).to(dev) for c in host]
    h2d_ms = median_ms(lambda: [torch.from_numpy(c).to(dev) for c in host])
    sort_ms = median_ms(lambda: sort_columns(*cols))
    perm_dev = sort_columns(*cols)
    d2h_ms = median_ms(lambda: perm_dev.cpu())
    perm = perm_dev.cpu().numpy()
    t0 = time.perf_counter()
    _ = rows[perm]
    gather_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = lexsort_rows(rows)
    lexsort_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    whole = make_device_sorter(dev)(rows)
    sorter_wall_ms = (time.perf_counter() - t0) * 1e3
    for name, got in (("sort_columns", perm), ("make_device_sorter", whole)):
        if got.dtype != np.int32 or not np.array_equal(got, ref):
            bad = int(np.argmax(got != ref))
            raise AssertionError(f"{name}'s permutation ({got.dtype}) differs "
                                 f"from lexsort_rows at {bad}")
    bound_ms = n * (3 * 8 + 4) / HBM_BYTES_PER_S * 1e3
    return {
        "metric": "device_key_sort", "records": n, "seed": SEED,
        "sort_ms": sort_ms, "records_per_s": n / sort_ms * 1e3,
        "key_MB_s": n * KEY_LEN / sort_ms / 1e3, "bound_ms": bound_ms,
        "h2d_ms": h2d_ms, "d2h_ms": d2h_ms, "host_columns_ms": host_columns_ms,
        "gather_ms": gather_ms, "lexsort_ms": lexsort_ms,
        "sorter_wall_ms": sorter_wall_ms, "perm_equals_lexsort": True,
        "device": torch.cuda.get_device_name(dev), "card": card_line(),
    }


# inode-space convention for the job's files (disjoint from meta's growing
# ids and from kvcache's (1<<63)|hash space)
IN_INODE = 0x5027 << 40          # + worker
RUN_INODE = 0x5027 << 40 | 1 << 32   # + (worker<<16 | partition)
OUT_INODE = 0x5027 << 40 | 2 << 32   # + partition


def _partition_of(rows: np.ndarray, parts: int) -> np.ndarray:
    """Range partition by the key's high 64 bits (parts must be 2^k so the
    cut points are exact bit shifts)."""
    hi = rows[:, 0:8].copy().view(">u8").ravel()
    if parts == 1:
        return np.zeros(len(hi), dtype=np.int64)
    return (hi >> np.uint64(64 - parts.bit_length() + 1)).astype(np.int64)


def check_writes(results, what: str) -> None:
    """Raise when a chunk write of one write_file_range failed: a failed
    write fails the job instead of passing as a short or stale file."""
    bad = [r.status for r in results if r.status.code != int(StatusCode.OK)]
    if bad:
        raise RuntimeError(f"sort_bench: {len(bad)} {what} chunk writes "
                           f"failed: {bad[0]}")


def _check_pow2(n: int, what: str) -> None:
    if n < 1 or n & (n - 1):
        raise SystemExit(f"{what} must be a power of two, got {n}")


async def run_bench(args) -> dict:
    _check_pow2(args.partitions, "--partitions")
    from t3fs_torch.benchmarks._env import make_env
    env, sc, chains = await make_env(args)
    try:
        return await _run_job(args, sc, chains)
    finally:
        await sc.close()
        await env.stop()


async def _cleanup_job_files(args, sc: StorageClient,
                             lay: FileLayout) -> None:
    """Remove this job's IN/RUN/OUT files.  Run both before (a previous
    crashed/differently-sized invocation against a live cluster leaves runs
    whose stale lengths would corrupt this one) and after (don't leak
    chunks on the cluster)."""
    inodes = ([IN_INODE + w for w in range(args.workers)]
              + [RUN_INODE + (w << 16 | p) for w in range(args.workers)
                 for p in range(args.partitions)]
              + [OUT_INODE + p for p in range(args.partitions)])
    await asyncio.gather(*(sc.remove_file_chunks(lay, inode)
                           for inode in inodes))


async def _run_job(args, sc: StorageClient, chains: list[int]) -> dict:
    lay = FileLayout(chunk_size=args.chunk_size, chains=chains)
    workers, parts = args.workers, args.partitions
    total_bytes = args.mb << 20
    rec_per_worker = total_bytes // REC_LEN // workers
    total_records = rec_per_worker * workers
    total_bytes = total_records * REC_LEN

    sorter = lexsort_rows
    if args.sort_backend == "device":
        sorter = make_device_sorter("cpu" if args.cpu else "cuda")

    await _cleanup_job_files(args, sc, lay)

    # --- input generation (not timed: gensort is the reference's untimed
    # input producer too) ---
    in_sum = np.uint64(0)
    for w in range(workers):
        rng = np.random.default_rng(args.seed + w)
        rows = rng.integers(0, 256, (rec_per_worker, REC_LEN), dtype=np.uint8)
        in_sum ^= np.bitwise_xor.reduce(
            rows[:, 0:8].copy().view(">u8").ravel())
        check_writes(await sc.write_file_range(lay, IN_INODE + w, 0,
                                               rows.tobytes()), "input")

    t_job0 = time.perf_counter()

    # --- phase 1: scan input, range-partition, write runs ---
    async def map_worker(w: int) -> None:
        data, _ = await sc.read_file_range(
            lay, IN_INODE + w, 0, rec_per_worker * REC_LEN)
        rows = np.frombuffer(data, dtype=np.uint8).reshape(-1, REC_LEN)
        p = _partition_of(rows, parts)
        order = np.argsort(p, kind="stable")
        sp = p[order]
        bounds = np.searchsorted(sp, np.arange(parts + 1))
        writes = []
        for part in range(parts):
            seg = rows[order[bounds[part]:bounds[part + 1]]]
            if len(seg):
                writes.append(sc.write_file_range(
                    lay, RUN_INODE + (w << 16 | part), 0, seg.tobytes()))
        for res in await asyncio.gather(*writes):
            check_writes(res, "run")

    await asyncio.gather(*(map_worker(w) for w in range(workers)))
    t_p1 = time.perf_counter()

    # --- phase 2: per partition, read runs (lengths via query_last_chunk),
    # sort, write output ---
    async def read_run(part: int, w: int) -> np.ndarray | None:
        inode = RUN_INODE + (w << 16 | part)
        length = await sc.query_last_chunk(lay, inode)
        if not length:
            return None
        data, _ = await sc.read_file_range(lay, inode, 0, length)
        return np.frombuffer(data, dtype=np.uint8).reshape(-1, REC_LEN)

    async def reduce_worker(part: int) -> tuple[int, np.uint64]:
        segs = [s for s in await asyncio.gather(
            *(read_run(part, w) for w in range(workers))) if s is not None]
        if not segs:
            return 0, np.uint64(0)
        rows = np.concatenate(segs) if len(segs) > 1 else segs[0]
        rows = rows[sorter(rows)]
        check_writes(await sc.write_file_range(lay, OUT_INODE + part, 0,
                                               rows.tobytes()), "output")
        return len(rows), np.bitwise_xor.reduce(
            rows[:, 0:8].copy().view(">u8").ravel())

    reduced = await asyncio.gather(*(reduce_worker(p) for p in range(parts)))
    t_p2 = time.perf_counter()

    # --- validation (untimed): outputs are sorted, contiguous across
    # partitions, and no record was lost or invented ---
    out_records = sum(n for n, _ in reduced)
    out_sum = np.uint64(0)
    for _, s in reduced:
        out_sum ^= s
    assert out_records == total_records, (out_records, total_records)
    assert out_sum == in_sum, "key checksum mismatch: records corrupted"
    prev_last = None
    for part in range(parts):
        n = reduced[part][0]
        if n == 0:
            continue
        data, _ = await sc.read_file_range(lay, OUT_INODE + part,
                                           0, n * REC_LEN)
        rows = np.frombuffer(data, dtype=np.uint8).reshape(-1, REC_LEN)
        # sorted iff a stable key-sort of the output is the identity
        assert np.array_equal(lexsort_rows(rows), np.arange(len(rows))), \
            f"partition {part} unsorted"
        flat = rows[:, :10].tobytes()
        if prev_last is not None:
            assert prev_last <= flat[:10], "partition boundary out of order"
        prev_last = flat[-10:]

    await _cleanup_job_files(args, sc, lay)

    wall = t_p2 - t_job0
    return {
        "records": total_records, "bytes": total_bytes,
        "workers": workers, "partitions": parts,
        "sort_backend": args.sort_backend,
        "phase1_s": round(t_p1 - t_job0, 3),
        "phase2_s": round(t_p2 - t_p1, 3),
        "sort_wall_s": round(wall, 3),
        "sort_MB_s": round(total_bytes / wall / 1e6, 2),
        "verified": True,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="sort_bench")
    ap.add_argument("--mgmtd", default="",
                    help="live cluster address; omit for in-process fabric")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--mb", type=int, default=32, help="input size in MiB")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--chunk-size", type=int, default=1 << 20)
    ap.add_argument("--sort-backend", choices=["numpy", "device"],
                    default="numpy")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--no-aio", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="the job's node CRCs on the host backend and its "
                         "device sort on the CPU")
    ap.add_argument("--records", type=int, default=None,
                    help="measure the device sort alone on N rows in memory")
    ap.add_argument("--quick", action="store_true",
                    help=f"measure the device sort alone on {QUICK_RECORDS} rows")
    args = ap.parse_args(argv)
    args.measure = args.quick or args.records is not None
    if args.measure and args.cpu:
        ap.error("--records and --quick time the card; --cpu is for the job")
    args.checksum_backend = "cpu" if args.cpu else "cuda"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card unless asked for the host: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    if args.measure:
        res = measure(gensort_rows(QUICK_RECORDS if args.quick else args.records))
        print(f"device sort of {res['records']} keys: {res['sort_ms']:.3f} ms "
              f"({res['records_per_s'] / 1e6:.1f} M records/s, {res['key_MB_s']:.0f} "
              f"key MB/s; bound {res['bound_ms']:.3f} ms by bytes); H2D "
              f"{res['h2d_ms']:.3f} ms, D2H {res['d2h_ms']:.3f} ms; host columns "
              f"{res['host_columns_ms']:.1f} ms, gather {res['gather_ms']:.1f} ms, "
              f"np.lexsort {res['lexsort_ms']:.1f} ms; make_device_sorter end to end "
              f"{res['sorter_wall_ms']:.1f} ms", flush=True)
        print(json.dumps(res), flush=True)
        return 0
    result = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f"{k:>14}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
