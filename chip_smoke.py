#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's write and read paths on one GPU and check
every kernel.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught into "ok"):
  0  report the card; build the kernels from t3fs_torch/csrc (into the
     ignored t3fs_torch/_build/) and print the build time
  1  B1 (CRC words) against its plain PyTorch version: random segments
     (4096 rows, and ragged 16-row units: 1, 7, 1001 rows), every run
     length 1..16 (chunks of 1..17, 24, 40 segments), 4 MiB chunks x 64, the
     check vector, front-padded odd lengths
  2  B2 (RAID-6 words) and the fused stripe step against plain, at the
     stripe bench's shape: RS(8+2), 1 MiB shards, 12 stripes
  3  storage write path: >= 256 concurrent payload_crc on the "tpu"
     checksum backend (mostly 4 MiB), every CRC checked
  4  EC stripe write path: 24 concurrent TorchECCodec.encode_verified on
     8 x 1 MiB shards, every parity byte and CRC checked
  5  CUDA-event times of B1 (64 x 4 MiB from HBM; 2 x 4 MiB resident in
     L2, replayed from a CUDA graph), B2 and the fused step beside their
     bounds (each the median of REPEATS samples, with their min and max)
  6  B3 (RAID-6 decode words), B4 (repair words) and B5 (byte-plane
     bit-matmul) against their plain versions: B3 on all 55 RS(8+2)
     erasure patterns of one 8 x 1 MiB stripe (uint4 and u32 paths), at
     RAID-6 k = 12, 31, 32 (survivors in several groups of 8) and at 12
     stripes for two patterns; B4 on the 10 single-row programs and the LRC
     all-ones program at 96 x 256 KiB sub-shards; B5 decode and encode on RS(6+3)
     (HDFS's RS-6-3-1024k policy) at 12 x 1 MiB shards; one rebuilt stripe
     of each kind against RSCode.decode_ref / eval_program_np
  7  degraded-read path: 24 concurrent TorchECCodec.reconstruct_verified on
     RS(8+2) 1 MiB shards in three erasure patterns (B3 + B1)
  8  repair path: 24 lost 1 MiB chunks of slot 3, each as 4 sub-shards of
     256 KiB over 8 helpers (96 concurrent repair calls, B4 + B1), CRCs
     stitched with crc32c_combine; then LRC local-parity encodes
  9  non-RAID-6 reconstruct: 12 concurrent RS(6+3) reconstruct calls at
     1 MiB shards losing 3 shards (B5)
 10  CUDA-event times of B3 (want (0, 9), (0, 1), (0, 5), (4, 8), (3,)),
     B4, B5 and the fused decode and repair steps beside their bounds (the
     decode step also replayed from a CUDA graph)
 11  B6 (CRC bytes) against its plain version: random segments, 64 x 4 MiB
     rows, 64 x (4 MiB - 5) rows (unaligned) and 64 x 1 000 000-byte rows
     (a ragged first run), rows at every base offset 0..15, odd lengths
     against crc32c_ref; the byte encode step (B5 + B6) and the byte decode
     step (B5 + B6) on RS(6+3) at 12 x 1 MiB against plain
 12  the byte-path EC routes: 24 concurrent RS(6+3) encode_verified at
     1 MiB cells (B5 + B6), 12 RS(6+3) reconstruct_verified losing 3
     shards (B5 + B6), 12 RAID-6 encode_verified at 1 000 000 bytes (B2 +
     B6), 24 repair calls at 250 000-byte sub-shards (B4 + B6); every
     parity, rebuilt byte and CRC checked
 13  PM-MSR on RS(8+2) pm-msr at 1 MiB chunks after warmup_msr: 24
     concurrent msr_encode_verified (B2 + B1), 24 msr_repair of slot 3
     (B4 + B1), 6 msr_decode_verified losing (0, 9) or (4, 9) (dense
     product + B1); one stripe of each against encode_np / repair_np /
     decode_np, every rebuilt byte and CRC checked
 17  codes past one kernel launch: B5's tiles (RAID-6 k = 254 decode in two
     input groups, RS(12+12) encode in two row groups, RS(28+8) decode of 8
     shards), B3's wrapper at k = 40 (B5 on the byte view) and B4 over 40
     helpers (two groups) against their plain versions; then 42 concurrent
     TorchECCodec calls at RAID-6 k = 40 and k = 254, RS(12+12) and RS(28+8)
     (encode_verified, reconstruct and reconstruct_verified of one and two
     losses, a 40-helper repair), every parity, rebuilt byte and CRC checked
 14  CUDA-event times of B6 at its three row shapes (beside B1's at the
     bytes of 64 x 4 MiB), the byte encode step and the PM-MSR repair step
 16  H1 (the bench's calibration copy) against its plain version at the
     bench's shape (12, 8, 256Ki words) and at ragged shapes, aligned and
     not; a CUDA-graph chained pass against the eager one; H1's time beside
     its bound, its plain version and torch.add, and H1 against torch.add in
     interleaved CUDA-graph replays; then the headline bench
     (`t3fs_torch.bench --quick`: value > 0, the card named, H1 launched)
     and the decode bench (--decode-ab at 12 x 1 MiB stripes)
 18  the device sort: 2^24 gensort rows (seed 2026) through sort_bench.measure
     (sort_columns and make_device_sorter both equal to lexsort_rows; the
     sort's CUDA-event time beside its bound, H2D, D2H, the host's column
     extraction and gather, np.lexsort), n = 0, 1, 1023, 1025 and all-0xFF
     keys against lexsort_rows, then `sort_bench --quick` (2^22)
 19  the codec mesh: graft_entry.run_mesh with 4 ranks, dp x cp = 2 x 2, at
     RS(8+2), 1 MiB shards, 24 stripes (NCCL with a card a rank, else gloo
     with the ranks sharing the card; the backend is printed): byte and word
     encode (B2 + B1), byte and word decode of want (0, 9) and (3,) (B3 +
     B1), the RS(6+3) word decode losing (1, 4, 7) (B5 + B1); every output
     against the unsharded steps on the card, CRCs spot-checked against
     crc32c_ref; each rank's step times beside those of B1, B2, B3, B5,
     the CRC combine and its all_reduce alone at the rank's block
 20  graft_entry.entry()'s step on the card against the plain step
 21  the CRAQ chain write (storage_bench's "CRAQ 3-replica chain write"):
     the port's StorageFabric of 3 nodes and one 3-replica chain, a
     CudaChecksumBackend per node on the card, the fabric's defaults (the
     native chunk engine, every target checked to be one, and io_uring
     reads), StorageClient with inline transfers, 4 MiB chunks; write_file_range of
     one seeded 512 MiB file, then phase 3's size mix through write_chunk
     on fresh inodes (1 MiB and (129 << 10) + 3 B writes, 40 000 B writes
     on the host path, appends through crc_combine, 1 MiB overwrites that
     recompute the chunk CRC on the host); once with write_pipeline "off",
     once with "overlap".  Every write is acked OK (the head's B1 CRC must
     equal the client's host CRC), every byte reads back, every replica's
     checksum equals the native host CRC of the expected bytes (full chunks
     also plain B1 on the card), every replica commits, and each node
     batched exactly its device-size updates; prints the wall and GB/s
 22  the EC stripe path (BASELINE.json configs #3 and #4): the port's
     StorageFabric of 5 nodes and 10 one-replica chains (two a node), a
     CudaChecksumBackend per node on the card, the native engine (every
     target checked) and io_uring reads, StorageClient and ECStorageClient
     over TorchECCodec; RS(8+2) at 1 MiB: 64 seeded stripes written 16 in
     flight (B2 + B1), read back healthy, every chunk of one chain removed
     and all 64 read degraded (B3 + B1), RepairDriver(concurrency=8) over
     the losses on the sub-shard path (B4 + B1), every stripe read back;
     then 8 stripes each of pm-msr (write, one-loss repair_stripe, two-loss
     read), RS(6+3) (write B5 + B6, read losing three shards, repair) and
     lrc-xor (6+2, groups of 4: write, a local-group repair), one RS(8+2)
     stripe ending mid-chunk (its trimmed tail's CRC on the host); last one
     node's server stops (two chains, the m = 2 limit) and 16 stripes read
     degraded.  Every byte against the written data, every returned CRC
     and every repaired chunk's stored checksum against plain B1 and the
     native host CRC, RepairDriver all on the reduced path, every codec
     route a cuda-* one; prints the walls, GB/s of data (write, degraded
     read) and of rebuilt and helper bytes (repair), codec flushes and
     items per flush, each node's B1 batches and items and io_uring reads,
     and the phase's launches
 15  the kernels line, the card line, then the ok line last

Every phase that drives TorchECCodec checks that no call took a plain
route on the card.  Launch counts: the counters are set to 0 just before
each main-path run (phases 3, 4, 7, 8, 9, 12, 13 and 17's codec calls, the
bench run of phase 16, which counts H1 only: its hundreds of B1 and B2
launches would drown the codec paths' counts, each mesh rank's one run of
its steps in phase 19, summed over the ranks, phase 20's step, each
pass of phase 21 and each step of phase 22, its warmups excepted) and read
just after; launches
made to compare a kernel with its plain version (phases 1, 2, 5, 6, 10, 11,
14, 16's checks and 17's kernel checks) are not counted.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import sys
import time

import numpy as np
import torch

SEED = 20261016
# H100 SXM HBM3 rate (NVIDIA data sheet); the bound of a kernel that only
# has to move its bytes
HBM_BYTES_PER_S = 3.35e12
K, M = 8, 2
SHARD_BYTES = 1 << 20          # stripe write: 1 MiB shards, 12 stripes a step
STRIPES = 12
CHUNK_BYTES = 4 << 20          # storage write: 4 MiB chunks, 64 a batch
CHAIN_FILE_BYTES = 512 << 20   # phase 21: one file, 128 chunks over 3 replicas
CHUNKS = 64
SUBSHARDS = 4                  # ec_client.subshard_r(1 MiB): 4 x 256 KiB reads
LOST_CHUNKS = 24               # repair: 24 lost chunks -> 96 sub-shard repairs
LOST_SLOT = 3
READ_PATTERNS = ((2,), (0, 5), (4, 8))
K63, M63 = 6, 3                # HDFS RS-6-3-1024k: RS(6+3), 1 MiB cells
LOST63 = (1, 4, 7)
LRC_GROUP = 3                  # ECLayout.local_group_size
ODD_CHUNK = 1_000_000          # a chunk length that is not whole 512-byte segments
MSR_LOSSES = ((0, 9), (4, 9))  # pm-msr two-loss reads: a data + a parity slot
# B3's timed patterns (phase 10): (0, 9) one Horner row and one XOR fold,
# (0, 1) the decode bench's, (0, 5) and (4, 8) phase 7's, (3,) a pure XOR fold
B3_WANTS = ((0, 9), (0, 1), (0, 5), (4, 8), (3,))
# RAID-6 k past one group of 8 survivors, up to B3's limit (phase 6)
B3_GROUP_KS = (12, 31, 32)
# B6's timed shapes (phase 14): whole segments, rows at all 16 misalignments,
# and ODD_CHUNK (1954 segments: runs of 16 after a ragged first run of 2)
B6_SHAPES = (("64 x 4 MiB", CHUNK_BYTES),
             ("64 x (4 MiB - 5), rows unaligned", CHUNK_BYTES - 5),
             ("64 x 1 000 000 B, ragged first run", ODD_CHUNK))
SORT_RECORDS = 1 << 24         # phase 18: one reduce partition, 1.68 GB of rows
# phase 19: a 2 x 2 mesh (4 ranks) at the stripe bench's width, 24 stripes;
# the word decode of a data and a parity shard, and of one data shard
MESH_RANKS, MESH_DP, MESH_STRIPES = 4, 2, 24
MESH_WANTS = ((0, 9), (3,))
# phase 22: 64 RS(8+2) stripes of 8 x 1 MiB (512 MiB of data), 16 calls in
# flight; 8 stripes each of pm-msr, RS(6+3) and lrc-xor; 16 reads after a
# node's server stops
EC_STRIPES = 64
EC_INFLIGHT = 16
EC_SMALL_STRIPES = 8
EC_NODE_LOSS_READS = 16
# a kernel's time is the median of this many samples of 20 calls each: one
# sample can sit well off the others, and the printed min and max show it
REPEATS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((u32(a) - u32(b)).abs().max().item()) if a.numel() else 0


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def expect_routes(codec, routes: tuple[str, ...]) -> None:
    for r in routes:
        expect(codec.codec_counts.get(r, 0) > 0, f"no call took route {r}")
    expect(all(r.startswith("cuda-") for r in codec.codec_counts),
           f"a plain route ran on the card: {codec.codec_counts}")


def rand_words(g: torch.Generator, dev: torch.device, *shape: int) -> torch.Tensor:
    return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                         device=dev, generator=g)


def front_padded_words(payloads: list[bytes], chunk_words: int,
                       dev: torch.device) -> torch.Tensor:
    arr = np.zeros((len(payloads), chunk_words * 4), dtype=np.uint8)
    for i, p in enumerate(payloads):
        arr[i, arr.shape[1] - len(p):] = np.frombuffer(p, dtype=np.uint8)
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def bucket_words(nbytes: int) -> int:
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend

    return CudaChecksumBackend._bucket_words(nbytes)


def plain_crcs(payloads: list[bytes], dev: torch.device, group: int = 8) -> list[int]:
    """CRC32C of each payload by the plain version of B1 (front-padded)."""
    from t3fs_torch.ops.crc32c import default_matrices
    from t3fs_torch.ops.cuda_codec import crc_words_raw_plain
    from t3fs_torch.ops.tables import codec_tables

    mats = default_matrices()
    out: dict[int, int] = {}
    by_bucket: dict[int, list[int]] = {}
    for i, p in enumerate(payloads):
        by_bucket.setdefault(bucket_words(len(p)), []).append(i)
    for cw, idx in by_bucket.items():
        tables = codec_tables(cw // 128, device=dev)
        for s in range(0, len(idx), group):
            part = idx[s:s + group]
            words = front_padded_words([payloads[i] for i in part], cw, dev)
            raw = u32(crc_words_raw_plain(words, tables)).cpu().tolist()
            for i, r in zip(part, raw):
                out[i] = r ^ mats.affine_const(len(payloads[i]))
    return [out[i] for i in range(len(payloads))]


# --- phase 1: B1 against plain -----------------------------------------------

def phase_crc(dev: torch.device, g: torch.Generator, chunk_words: int,
              chunks: int, seg_rows: int) -> int:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref, default_matrices
    from t3fs_torch.ops.tables import codec_tables

    worst = 0
    t1 = codec_tables(1, device=dev)
    for rows in (seg_rows, 1, 7, 1001):          # whole and ragged 16-row units
        segs = rand_words(g, dev, rows, 128)
        e = max_abs_err(cc.crc_seg_words(segs, t1), cc.crc_seg_words_plain(segs, t1))
        log(f"[1] crc_seg_words ({rows}, 128): max_abs_err={e}")
        worst = max(worst, e)
    # every run length the wrapper picks: spw = nseg for nseg <= 16
    e = 0
    for nseg in (*range(1, 17), 17, 24, 40):
        tn = codec_tables(nseg, device=dev)
        w = rand_words(g, dev, 3, nseg * 128)
        e = max(e, max_abs_err(cc.crc_words_raw(w, tn), cc.crc_words_raw_plain(w, tn)))
    log(f"[1] crc_words_raw (3, nseg * 128) for nseg 1..17, 24, 40 (every run "
        f"length 1..16): max_abs_err={e}")
    worst = max(worst, e)

    tables = codec_tables(chunk_words // 128, device=dev)
    words = rand_words(g, dev, chunks, chunk_words)
    got = cc.crc_words_raw(words, tables)
    subset = sorted({0, chunks // 3, chunks - 1})
    e = max_abs_err(got[subset], cc.crc_words_raw_plain(words[subset], tables))
    log(f"[1] crc_words_raw ({chunks}, {chunk_words}) = {chunks} x "
        f"{chunk_words * 4 >> 10} KiB: max_abs_err={e} on rows {subset} "
        "(the plain version expands every byte to 8 floats, so it runs on a "
        "subset)")
    worst = max(worst, e)

    mats = default_matrices()
    check = front_padded_words([b"123456789"], 128, dev)
    crc = int(u32(cc.crc_words_raw(check, t1)).item()) ^ mats.affine_const(9)
    log(f"[1] check vector crc32c(b'123456789') = {crc:#010x}")
    expect(crc == 0xE3069283, "check vector")

    rng = np.random.default_rng(SEED + 1)
    for n in (1000, (64 << 10) + 3, (129 << 10) + 3, chunk_words * 4 - 5):
        p = rng.bytes(n)
        cw = bucket_words(n)
        tw = codec_tables(cw // 128, device=dev)
        raw = int(u32(cc.crc_words_raw(front_padded_words([p], cw, dev), tw)).item())
        crc = raw ^ mats.affine_const(n)
        ref = crc32c_ref(p) if n <= (256 << 10) else plain_crcs([p], dev)[0]
        e = abs(crc - ref)
        log(f"[1] front-padded length {n}: crc={crc:#010x} ref={ref:#010x}")
        worst = max(worst, e)
    expect(worst == 0, f"B1 disagrees with its plain version (max_abs_err={worst})")
    return worst


# --- phase 2: B2 and the fused step against plain ----------------------------

def phase_stripe(dev: torch.device, g: torch.Generator, shard_words: int,
                 stripes: int) -> tuple[int, int]:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import codec_tables
    from t3fs_torch.ops.torch_codec import i32

    tables = codec_tables(shard_words // 128, K, M, device=dev)
    words = rand_words(g, dev, stripes, K, shard_words)
    plain_par = cc.rs_raid6_words_plain(words, tables)
    e_rs = max_abs_err(cc.rs_raid6_words(words, tables), plain_par)
    log(f"[2] rs_raid6_words ({stripes}, {K}, {shard_words}): max_abs_err={e_rs}")

    step = cc.make_stripe_encode_step_words(shard_words, K, M, device=dev)
    parity, crcs = step(words)
    plain_crc = torch.cat([
        cc.crc_words_raw_plain(words.reshape(stripes * K, shard_words), tables)
        .reshape(stripes, K),
        cc.crc_words_raw_plain(plain_par.reshape(stripes * M, shard_words), tables)
        .reshape(stripes, M)], dim=1) ^ i32(tables.chunk_affine)
    e_par = max_abs_err(parity, plain_par)
    e_crc = max_abs_err(crcs, plain_crc)
    log(f"[2] fused stripe step: parity max_abs_err={e_par}, "
        f"crcs ({stripes}, {K + M}) max_abs_err={e_crc}")

    data0 = words[0].cpu().numpy().view(np.uint8)               # (k, L) bytes
    ref_par = default_rs(K, M).encode_ref(data0)
    par0 = parity[0].cpu().numpy().view(np.uint8)
    expect(np.array_equal(par0, ref_par), "stripe 0 parity != RSCode.encode_ref")
    c0 = crc32c_ref(data0[0].tobytes())
    expect(int(u32(crcs[0, 0]).item()) == c0, "stripe 0 shard 0 CRC != crc32c_ref")
    log("[2] stripe 0 parity == RSCode.encode_ref, shard 0 CRC == crc32c_ref")
    expect(e_rs == 0 and e_par == 0 and e_crc == 0,
           "B2 or the fused step disagrees with its plain version")
    return e_rs, e_crc


# --- phase 3: storage write path ---------------------------------------------

def storage_sizes(chunk_bytes: int) -> list[int]:
    """The write mix: mostly full chunks, some 1 MiB, some odd lengths above
    the 64 KiB cutoff, and a few below it (host path)."""
    return ([chunk_bytes] * 208 + [chunk_bytes // 4] * 32
            + [(129 << 10) + 3] * 12 + [40_000] * 4)


async def phase_storage(dev: torch.device, sizes: list[int]) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend, make_checksum_backend)
    from t3fs_torch.utils.status import StatusError

    backend = make_checksum_backend("tpu", device=dev)
    expect(isinstance(backend, CudaChecksumBackend), "'tpu' must map to CUDA")
    rng = np.random.default_rng(SEED + 3)
    order = rng.permutation(len(sizes))
    payloads = [rng.bytes(sizes[i]) for i in order]
    device_items = sum(len(p) >= DEFAULT_MIN_DEVICE_BYTES for p in payloads)

    cc.reset_launches()
    t0 = time.perf_counter()
    crcs = await asyncio.gather(*(backend.payload_crc(p) for p in payloads))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)

    ref = plain_crcs(payloads, dev)
    for i, p in enumerate(payloads):
        if len(p) < (256 << 10):
            ref[i] = crc32c_ref(p)      # odd and host-path lengths: the oracle
    bad = [i for i, (c, r) in enumerate(zip(crcs, ref)) if c != r]
    total = sum(len(p) for p in payloads)
    log(f"[3] storage write path: {len(payloads)} concurrent payload_crc, "
        f"{total / 2**20:.1f} MiB, {device_items} on the device in "
        f"{backend.batches} buckets ({backend.batched_items} items); "
        f"crc_words launches={launches['crc_words']}; wall {wall:.3f} s "
        f"({total / wall / 1e9:.2f} GB/s host clock); wrong CRCs: {len(bad)}")
    expect(not bad, f"storage path: {len(bad)} wrong CRCs")
    expect(backend.batched_items == device_items, "every >=64 KiB payload batched")
    expect(launches["crc_words"] == backend.batches > 0,
           "one B1 launch per device bucket")

    await backend.close()
    try:
        await backend.payload_crc(b"x" * (1 << 20))
    except StatusError:
        log("[3] payload_crc after close() fails fast")
    else:
        raise AssertionError("payload_crc after close() must fail")
    return launches


# --- phase 4: EC stripe write path -------------------------------------------

async def phase_ec(dev: torch.device, shard_bytes: int, requests: int) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import codec_tables
    from t3fs_torch.ops.torch_codec import i32

    rng = np.random.default_rng(SEED + 4)
    stripes = [rng.integers(0, 256, (K, shard_bytes), dtype=np.uint8)
               for _ in range(requests)]
    codec = TorchECCodec(device=dev)
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(codec.encode_verified(s, K, M) for s in stripes))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()

    W = shard_bytes // 4
    tables = codec_tables(W // 128, K, M, device=dev)
    words = torch.from_numpy(np.stack(stripes).view(np.int32)).to(dev)
    plain_par = cc.rs_raid6_words_plain(words, tables)
    par = torch.from_numpy(np.stack([o[0] for o in outs]).view(np.int32)).to(dev)
    e_par = max_abs_err(par, plain_par)
    n = len(stripes)
    plain_crc = torch.cat([
        cc.crc_words_raw_plain(words.reshape(n * K, W), tables).reshape(n, K),
        cc.crc_words_raw_plain(plain_par.reshape(n * M, W), tables).reshape(n, M),
    ], dim=1) ^ i32(tables.chunk_affine)
    got_crc = torch.from_numpy(np.stack([o[1] for o in outs]).view(np.int32)).to(dev)
    e_crc = max_abs_err(got_crc, plain_crc)
    expect(np.array_equal(outs[0][0], default_rs(K, M).encode_ref(stripes[0])),
           "stripe 0 parity != RSCode.encode_ref")
    log(f"[4] EC stripe write path: {n} concurrent encode_verified "
        f"({K} x {shard_bytes >> 10} KiB), {codec.batches} batches, "
        f"codec_counts={codec.codec_counts}, launches={launches}, wall "
        f"{wall:.3f} s; parity max_abs_err={e_par}, crcs max_abs_err={e_crc}")
    expect(e_par == 0 and e_crc == 0, "EC path disagrees with plain")
    expect_routes(codec, ("cuda-encode-words",))
    expect(launches["rs_raid6_words"] > 0 and launches["crc_words"] > 0,
           "EC path must launch B2 and B1")
    return launches


# --- phase 5: times ----------------------------------------------------------

def time_ms(fn, iters: int, warm: int = 2) -> float:
    from t3fs_torch.benchmarks.devbench import event_ms

    return event_ms(fn, iters, warm)


def kernel_times(fn) -> dict:
    """ms per call: the median of REPEATS samples of 20 calls, and the
    samples' min and max."""
    samples = sorted(time_ms(fn, 20, warm=2 if i == 0 else 0)
                     for i in range(REPEATS))
    return {"ms": samples[len(samples) // 2], "min_ms": samples[0],
            "max_ms": samples[-1]}


def graph_kernel_times(fn) -> dict:
    """kernel_times of 20 calls captured once in a CUDA graph and replayed:
    for a call too short to hide the host's launch overhead."""
    from t3fs_torch.benchmarks.devbench import graph_samples

    samples = graph_samples(fn, 20, REPEATS)
    return {"ms": samples[len(samples) // 2], "min_ms": samples[0],
            "max_ms": samples[-1]}


def log_times(phase: int, out: dict) -> None:
    for name, t in out.items():
        log(f"[{phase}] {name} {t['shape']}: {t['ms'] * 1e3:.1f} us, median of "
            f"{REPEATS} (min {t['min_ms'] * 1e3:.1f}, max {t['max_ms'] * 1e3:.1f}) "
            f"(bound {t['bound_ms'] * 1e3:.1f} us by bytes at 3.35 TB/s, "
            f"{t['bound_ms'] / t['ms'] * 100:.1f}% of it); plain "
            f"{t['plain_ms'] * 1e3:.1f} us; library call: none")


def phase_times(dev: torch.device, g: torch.Generator) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    out = {}
    cw = CHUNK_BYTES // 4
    tcrc = codec_tables(cw // 128, device=dev)
    words = rand_words(g, dev, CHUNKS, cw)
    nbytes = words.numel() * 4
    out["crc_words"] = {
        **kernel_times(lambda: cc.crc_words_raw(words, tcrc)),
        "plain_ms": time_ms(lambda: cc.crc_words_raw_plain(words, tcrc), 2, 1),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"({CHUNKS}, {cw}) = {CHUNKS} x 4 MiB chunks",
    }
    l2 = words[:2]               # 8 MiB: stays in the 50 MB L2 across calls
    out["crc_words 8 MiB, L2-resident, CUDA graph"] = {
        **graph_kernel_times(lambda: cc.crc_words_raw(l2, tcrc)),
        "plain_ms": time_ms(lambda: cc.crc_words_raw_plain(l2, tcrc), 2, 1),
        "bound_ms": l2.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "shape": f"(2, {cw}) = 2 x 4 MiB chunks",
    }
    del words, l2
    sw = SHARD_BYTES // 4
    trs = codec_tables(sw // 128, K, M, device=dev)
    data = rand_words(g, dev, STRIPES, K, sw)
    rs_bytes = (K + M) * sw * 4 * STRIPES
    out["rs_raid6_words"] = {
        **kernel_times(lambda: cc.rs_raid6_words(data, trs)),
        "plain_ms": time_ms(lambda: cc.rs_raid6_words_plain(data, trs), 5),
        "bound_ms": rs_bytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"({STRIPES}, {K}, {sw}) = {STRIPES} stripes of {K} x 1 MiB",
    }
    step = cc.make_stripe_encode_step_words(sw, K, M, device=dev)

    def plain_step():
        par = cc.rs_raid6_words_plain(data, trs)
        cc.crc_words_raw_plain(data.reshape(STRIPES * K, sw), trs)
        cc.crc_words_raw_plain(par.reshape(STRIPES * M, sw), trs)

    out["stripe_step"] = {
        **kernel_times(lambda: step(data)),
        "plain_ms": time_ms(plain_step, 2, 1),
        "bound_ms": rs_bytes / HBM_BYTES_PER_S * 1e3,
        "shape": out["rs_raid6_words"]["shape"],
    }
    log_times(5, out)
    return out


# --- phase 6: B3, B4 and B5 against plain ------------------------------------

def erasure_patterns(n: int = K + M) -> list[tuple[tuple[int, ...], tuple[int, ...]]]:
    """The 55 single and double erasures of RS(8+2): (present, want), present
    the first k survivors, as the EC client picks them."""
    losses = [(a,) for a in range(n)] + [(a, b) for a in range(n)
                                          for b in range(a + 1, n)]
    return [(present_of(lost, n, K), lost) for lost in losses]


def present_of(lost: tuple[int, ...], n: int, k: int) -> tuple[int, ...]:
    return tuple(s for s in range(n) if s not in lost)[:k]


def repair_plan(lost: int) -> tuple[list[int], tuple[int, ...]]:
    """ec_client._plan_reduced without holes: helpers sorted(survivors)[:k]
    and the single-row coefficients, zero ones dropped."""
    from t3fs_torch.ops.rs import default_rs

    present = sorted(s for s in range(K + M) if s != lost)[:K]
    row = default_rs(K, M).reconstruct_gfmatrix(present, [lost])[0]
    keep = [(s, int(c)) for s, c in zip(present, row) if c]
    return [s for s, _ in keep], tuple(c for _, c in keep)


def phase_read_kernels(dev: torch.device, g: torch.Generator) -> dict[str, int]:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.repair_program import (
        eval_program_np, schedule_repair_program, single_row_program, xor_program)
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import decode_tables, encode_map_tables, repair_tables

    rs = default_rs(K, M)
    W = SHARD_BYTES // 4
    errs = {}
    one = rand_words(g, dev, 1, K, W)
    odd = one[:, :, :W - 1].contiguous()         # w % 4 != 0: the u32 path
    e = 0
    for present, want in erasure_patterns():
        dec = decode_tables(present, want, rs, dev)
        for x in (one, odd):
            e = max(e, max_abs_err(cc.rs_reconstruct_words(x, dec),
                                   cc.rs_reconstruct_words_plain(x, dec)))
    log(f"[6] rs_reconstruct_words, all 55 RS(8+2) erasure patterns at (1, {K}, "
        f"{W}) (uint4 path) and (1, {K}, {W - 1}) (u32 path): max_abs_err={e}")
    for kk in B3_GROUP_KS:                       # survivors in several groups of 8
        rsk = default_rs(kk, M)
        x = rand_words(g, dev, 4, kk, W // 4)
        ek = 0
        for lost in ((0, kk + 1), (kk // 2,), (3, kk)):
            dec = decode_tables(present_of(lost, kk + M, kk), lost, rsk, dev)
            for xx in (x, x[:, :, 1:].contiguous()):
                ek = max(ek, max_abs_err(cc.rs_reconstruct_words(xx, dec),
                                         cc.rs_reconstruct_words_plain(xx, dec)))
        log(f"[6] rs_reconstruct_words RAID-6 k = {kk} at (4, {kk}, {W // 4}) and "
            f"(4, {kk}, {W // 4 - 1}), 3 patterns: max_abs_err={ek}")
        e = max(e, ek)
    words = rand_words(g, dev, STRIPES, K, W)
    for want in ((3,), (0, 9)):
        dec = decode_tables(present_of(want, K + M, K), want, rs, dev)
        got = cc.rs_reconstruct_words(words, dec)
        ew = max_abs_err(got, cc.rs_reconstruct_words_plain(words, dec))
        log(f"[6] rs_reconstruct_words want={want} at ({STRIPES}, {K}, {W}): "
            f"max_abs_err={ew}")
        e = max(e, ew)
    surv = words[0].cpu().numpy().view(np.uint8)
    present = present_of((0, 9), K + M, K)
    ref = rs.decode_ref(dict(zip(present, surv)), [0, 9])
    expect(np.array_equal(got[0].cpu().numpy().view(np.uint8), ref),
           "B3 stripe 0 != RSCode.decode_ref")
    errs["rs_reconstruct_words"] = e

    hw = SHARD_BYTES // SUBSHARDS // 4
    helpers = rand_words(g, dev, LOST_CHUNKS * SUBSHARDS, K, hw)
    progs = [single_row_program(rs, present_of((lost,), K + M, K), lost)
             for lost in range(K + M)] + [xor_program(LRC_GROUP)]
    e = 0
    for prog in progs:
        rep = repair_tables(prog, rs)
        x = helpers[:, :prog.num_helpers].contiguous()
        got = cc.repair_words(x, rep)
        e = max(e, max_abs_err(got, cc.repair_words_plain(x, rep)))
        ref = eval_program_np(prog, x[0].cpu().numpy().view(np.uint8), rs)
        expect(np.array_equal(got[0].cpu().numpy().view(np.uint8), ref),
               f"B4 row 0 != eval_program_np for {prog.coeffs}")
    slots, coeffs = repair_plan(LOST_SLOT)
    expect(schedule_repair_program(coeffs).is_xor, "slot 3's plan is the XOR fold")
    log(f"[6] repair_words, {len(progs)} programs (10 single-row + LRC all-ones "
        f"over {LRC_GROUP}) at ({LOST_CHUNKS * SUBSHARDS}, h, {hw}): "
        f"max_abs_err={e}; row 0 of each == eval_program_np")
    errs["repair_words"] = e
    del helpers, words

    rs63 = default_rs(K63, M63)
    shards = torch.randint(0, 256, (STRIPES, K63, SHARD_BYTES), dtype=torch.uint8,
                           device=dev, generator=g)
    present = present_of(LOST63, K63 + M63, K63)
    dec = decode_tables(present, LOST63, rs63, dev)
    enc = encode_map_tables(rs63, dev)
    got_d, got_e = cc.rs_bitmatmul(shards, dec), cc.rs_bitmatmul(shards, enc)
    e = max(max_abs_err(got_d, cc.rs_bitmatmul_plain(shards, dec)),
            max_abs_err(got_e, cc.rs_bitmatmul_plain(shards, enc)))
    s0 = shards[0].cpu().numpy()
    expect(np.array_equal(got_d[0].cpu().numpy(),
                          rs63.decode_ref(dict(zip(present, s0)), list(LOST63))),
           "B5 decode stripe 0 != RSCode.decode_ref")
    expect(np.array_equal(got_e[0].cpu().numpy(), rs63.encode_ref(s0)),
           "B5 encode stripe 0 != RSCode.encode_ref")
    log(f"[6] rs_bitmatmul RS({K63}+{M63}) decode want={LOST63} and encode at "
        f"({STRIPES}, {K63}, {SHARD_BYTES}), compared in full: max_abs_err={e}; "
        "stripe 0 == RSCode.decode_ref / encode_ref")
    errs["rs_bitmatmul"] = e
    expect(max(errs.values()) == 0, f"B3/B4/B5 disagree with plain: {errs}")
    return errs


def raid6_stripes(dev: torch.device, g: torch.Generator, n: int) -> np.ndarray:
    """(n, k+m, 1 MiB) uint8 stripes: random data, parity by B2 (held
    against RSCode.encode_ref in phase 2)."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    W = SHARD_BYTES // 4
    data = rand_words(g, dev, n, K, W)
    parity = cc.rs_raid6_words(data, codec_tables(1, K, M, device=dev))
    full = torch.cat([data, parity], dim=1).cpu().numpy()
    return full.view(np.uint8)


def plain_shard_crcs(full: np.ndarray, dev: torch.device) -> np.ndarray:
    """(n, s, L) uint8 -> (n, s) uint32 CRC32C by the plain version of B1."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables
    from t3fs_torch.ops.torch_codec import i32

    n, s, L = full.shape
    tables = codec_tables(L // 512, device=dev)
    words = torch.from_numpy(np.ascontiguousarray(full).view(np.int32)).to(dev)
    raw = torch.cat([cc.crc_words_raw_plain(part, tables)
                     for part in words.reshape(n * s, L // 4).split(48)])
    return (raw ^ i32(tables.chunk_affine)).cpu().numpy().view(np.uint32).reshape(n, s)


# --- phase 7: degraded-read path --------------------------------------------

async def phase_degraded(dev: torch.device, full: np.ndarray,
                         crcs: np.ndarray) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc

    codec = TorchECCodec(device=dev)
    # build each pattern's step (tables, first launch) off the timed path
    codec.warmup_decode([(present_of(w, K + M, K), w) for w in READ_PATTERNS],
                        full.shape[-1], K, M, batch_sizes=(8,))
    reqs = []
    for i in range(full.shape[0]):
        want = READ_PATTERNS[i % len(READ_PATTERNS)]
        present = present_of(want, K + M, K)
        reqs.append((i, present, want, np.ascontiguousarray(full[i, list(present)])))
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(codec.reconstruct_verified(rows, p, w, K, M)
                                  for _i, p, w, rows in reqs))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()
    bad_bytes = bad_crcs = 0
    for (i, present, want, _rows), (rebuilt, got) in zip(reqs, outs):
        bad_bytes += not np.array_equal(rebuilt, full[i, list(want)])
        bad_crcs += not np.array_equal(got, crcs[i, list(present + want)])
    log(f"[7] degraded-read path: {len(reqs)} concurrent reconstruct_verified "
        f"(RS({K}+{M}), {SHARD_BYTES >> 10} KiB shards, patterns {READ_PATTERNS}, "
        "after warmup_decode; codec_counts include the warmups): "
        f"{codec.flushes} flush(es), {codec.batches} groups, "
        f"{codec.batched_items} items, codec_counts={codec.codec_counts}, "
        f"launches={launches}, wall {wall:.3f} s; wrong stripes {bad_bytes}, "
        f"wrong CRC rows {bad_crcs}")
    expect(bad_bytes == 0 and bad_crcs == 0, "degraded reads disagree")
    expect_routes(codec, ("cuda-decode-words",))
    expect(codec.batches >= len(READ_PATTERNS), "one group per pattern")
    expect(launches["rs_reconstruct_words"] >= len(READ_PATTERNS)
           and launches["crc_words"] > 0, "degraded reads must launch B3 and B1")
    return launches


# --- phase 8: repair path ----------------------------------------------------

async def phase_repair(dev: torch.device, full: np.ndarray,
                       crcs: np.ndarray) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.codec import crc32c_combine

    slots, coeffs = repair_plan(LOST_SLOT)
    sub = SHARD_BYTES // SUBSHARDS
    n = LOST_CHUNKS
    codec = TorchECCodec(device=dev)
    codec.warmup_repair([coeffs], sub, K, M, batch_sizes=(32,))
    codec.warmup_repair([(1, 1, 1), (1, 1)], full.shape[-1], K, M,
                        batch_sizes=(STRIPES,))
    jobs = [np.ascontiguousarray(full[i, slots, q * sub:(q + 1) * sub])
            for i in range(n) for q in range(SUBSHARDS)]
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(codec.repair(rows, coeffs, K, M) for rows in jobs))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    groups, flushes = codec.batches, codec.flushes

    t1 = time.perf_counter()
    stitched = []
    for i in range(n):
        parts = outs[i * SUBSHARDS:(i + 1) * SUBSHARDS]
        crc = int(parts[0][1])
        for _p, c in parts[1:]:
            crc = crc32c_combine(crc, int(c), sub)
        stitched.append(crc)
    stitch_s = time.perf_counter() - t1
    bad_bytes = sum(not np.array_equal(
        np.concatenate([p for p, _c in outs[i * SUBSHARDS:(i + 1) * SUBSHARDS]]),
        full[i, LOST_SLOT]) for i in range(n))
    bad_crcs = sum(c != int(crcs[i, LOST_SLOT]) for i, c in enumerate(stitched))
    log(f"[8] repair path, after warmup_repair: {len(jobs)} concurrent repair calls ({n} lost "
        f"{SHARD_BYTES >> 10} KiB chunks of slot {LOST_SLOT} x {SUBSHARDS} "
        f"sub-shards of {sub >> 10} KiB over helpers {slots}, coeffs {coeffs}): "
        f"{flushes} flushes, {groups} groups, launches={launches}, wall "
        f"{wall:.3f} s; {n * (SUBSHARDS - 1)} crc32c_combine stitches took "
        f"{stitch_s * 1e3:.1f} ms; wrong chunks {bad_bytes}, wrong stitched "
        f"CRCs {bad_crcs}")
    expect(bad_bytes == 0 and bad_crcs == 0, "repairs disagree")

    # LRC local parities of a write: the all-ones program at the full chunk
    lrc = [(0, 1, 2), (3, 4, 5), (6, 7), (8, 9)]          # local_groups(), size 3
    stripes = STRIPES
    jobs = [(i, grp) for i in range(stripes) for grp in lrc]
    cc.reset_launches()
    t0 = time.perf_counter()
    louts = await asyncio.gather(*(
        codec.repair(np.ascontiguousarray(full[i, list(grp)]), (1,) * len(grp), K, M)
        for i, grp in jobs))
    lwall = time.perf_counter() - t0
    for name, v in cc.launches.items():
        launches[name] += v
    await codec.close()
    xors = np.stack([np.bitwise_xor.reduce(full[i, list(grp)], axis=0)
                     for i, grp in jobs])
    bad_lrc = sum(not np.array_equal(o, x) for (o, _c), x in zip(louts, xors))
    want_crc = plain_shard_crcs(xors[None], dev)[0]
    bad_lrc_crc = sum(int(c) != int(w) for (_o, c), w in zip(louts, want_crc))
    log(f"[8] LRC local-parity encodes: {len(jobs)} concurrent repair(rows, "
        f"(1,)*g) at {SHARD_BYTES >> 10} KiB (groups {lrc}), wall {lwall:.3f} s; "
        f"codec_counts={codec.codec_counts}; wrong parities {bad_lrc}, wrong "
        f"CRCs {bad_lrc_crc}")
    expect(bad_lrc == 0 and bad_lrc_crc == 0, "LRC local parities disagree")
    expect_routes(codec, ("cuda-repair-words",))
    expect(launches["repair_words"] > 0 and launches["crc_words"] > 0,
           "repair must launch B4 and B1")
    return launches


# --- phase 9: non-RAID-6 reconstruct ----------------------------------------

async def phase_nonraid6(dev: torch.device, g: torch.Generator) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rs63 = default_rs(K63, M63)
    data = torch.randint(0, 256, (STRIPES, K63, SHARD_BYTES), dtype=torch.uint8,
                         device=dev, generator=g)
    # parity by the plain PyTorch bit-matmul, independent of B5
    parity = make_rs_encode_matmul(rs63, dev)(data)
    full = torch.cat([data, parity], dim=1).cpu().numpy()
    del data, parity
    present = present_of(LOST63, K63 + M63, K63)
    codec = TorchECCodec(device=dev)
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*(
        codec.reconstruct(np.ascontiguousarray(f[list(present)]), present, LOST63,
                          K63, M63) for f in full))
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()
    bad = sum(not np.array_equal(o, f[list(LOST63)]) for o, f in zip(outs, full))
    log(f"[9] non-RAID-6 reconstruct: {len(outs)} concurrent RS({K63}+{M63}) "
        f"reconstruct at {SHARD_BYTES >> 10} KiB shards, want={LOST63}: "
        f"{codec.batches} groups, codec_counts={codec.codec_counts}, "
        f"launches={launches}, wall {wall:.3f} s; wrong stripes {bad}")
    expect(bad == 0, "RS(6+3) reconstruct disagrees")
    expect_routes(codec, ("cuda-bitmatmul",))
    expect(launches["rs_bitmatmul"] > 0, "RS(6+3) reconstruct must launch B5")
    return launches


# --- phase 10: read-side times ----------------------------------------------

def phase_read_times(dev: torch.device, g: torch.Generator) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.repair_program import schedule_repair_program, single_row_program
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import (
        codec_tables, decode_tables, encode_map_tables, repair_tables)

    rs = default_rs(K, M)
    out = {}
    W = SHARD_BYTES // 4
    words = rand_words(g, dev, STRIPES, K, W)
    tcrc = codec_tables(W // 128, device=dev)
    for want in B3_WANTS:
        present = present_of(want, K + M, K)
        dec = decode_tables(present, want, rs, dev)
        out[f"rs_reconstruct_words want={want}"] = {
            **kernel_times(lambda: cc.rs_reconstruct_words(words, dec)),
            "plain_ms": time_ms(lambda: cc.rs_reconstruct_words_plain(words, dec), 5),
            "bound_ms": (K + len(want)) * W * 4 * STRIPES / HBM_BYTES_PER_S * 1e3,
            "shape": f"({STRIPES}, {K}, {W}) -> ({STRIPES}, {len(want)}, {W})",
        }
    present, want = present_of((0, 9), K + M, K), (0, 9)
    step = cc.make_stripe_decode_step_words(W, present, want, K, M, device=dev)
    dec = decode_tables(present, want, rs, dev)

    def plain_decode_step():
        reb = cc.rs_reconstruct_words_plain(words, dec)
        cc.crc_words_raw_plain(words.reshape(STRIPES * K, W), tcrc)
        cc.crc_words_raw_plain(reb.reshape(STRIPES * 2, W), tcrc)

    out["decode_step want=(0, 9)"] = {
        **kernel_times(lambda: step(words)),
        "plain_ms": time_ms(plain_decode_step, 2, 1),
        "bound_ms": (K + 2) * W * 4 * STRIPES / HBM_BYTES_PER_S * 1e3,
        "shape": f"({STRIPES}, {K}, {W})",
    }
    # the step's time from the host against its time on the card alone
    out["decode_step want=(0, 9), CUDA graph"] = {
        **out["decode_step want=(0, 9)"], **graph_kernel_times(lambda: step(words)),
    }
    del words

    hw = SHARD_BYTES // SUBSHARDS // 4
    rows = LOST_CHUNKS * SUBSHARDS
    helpers = rand_words(g, dev, rows, K, hw)
    _slots, coeffs = repair_plan(LOST_SLOT)
    main_prog = schedule_repair_program(coeffs)
    for label, prog in (("slot 3, XOR fold", main_prog),
                        ("slot 9, Horner", single_row_program(
                            rs, present_of((9,), K + M, K), 9))):
        rep = repair_tables(prog, rs)
        out[f"repair_words {label}"] = {
            **kernel_times(lambda: cc.repair_words(helpers, rep)),
            "plain_ms": time_ms(lambda: cc.repair_words_plain(helpers, rep), 5),
            "bound_ms": (K + 1) * hw * 4 * rows / HBM_BYTES_PER_S * 1e3,
            "shape": f"({rows}, {K}, {hw}) -> ({rows}, {hw})",
        }
    rstep = cc.make_repair_step_words(hw, main_prog, device=dev)
    trep = codec_tables(hw // 128, device=dev)
    rep = repair_tables(main_prog, rs)

    def plain_repair_step():
        cc.crc_words_raw_plain(cc.repair_words_plain(helpers, rep), trep)

    out["repair_step slot 3"] = {
        **kernel_times(lambda: rstep(helpers)),
        "plain_ms": time_ms(plain_repair_step, 2, 1),
        "bound_ms": (K + 1) * hw * 4 * rows / HBM_BYTES_PER_S * 1e3,
        "shape": f"({rows}, {K}, {hw})",
    }
    del helpers

    rs63 = default_rs(K63, M63)
    shards = torch.randint(0, 256, (STRIPES, K63, SHARD_BYTES), dtype=torch.uint8,
                           device=dev, generator=g)
    for label, gmap in (
            (f"decode want={LOST63}", decode_tables(
                present_of(LOST63, K63 + M63, K63), LOST63, rs63, dev)),
            ("encode", encode_map_tables(rs63, dev))):
        out[f"rs_bitmatmul RS(6+3) {label}"] = {
            **kernel_times(lambda: cc.rs_bitmatmul(shards, gmap)),
            "plain_ms": time_ms(lambda: cc.rs_bitmatmul_plain(shards, gmap), 2, 1),
            "bound_ms": (K63 + gmap.rows) * SHARD_BYTES * STRIPES / HBM_BYTES_PER_S * 1e3,
            "shape": f"({STRIPES}, {K63}, {SHARD_BYTES}) -> ({STRIPES}, {gmap.rows}, "
                     f"{SHARD_BYTES}) u8",
        }
    log_times(10, out)
    return out


# --- phase 11: B6 and the byte steps against plain ----------------------------

def plain_crc_bytes(rows: torch.Tensor, group: int = 16) -> torch.Tensor:
    """(n, L) uint8 -> (n,) int32 CRC32C by the plain version of B6, in
    groups of rows (it expands every byte to 8 floats)."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import default_matrices
    from t3fs_torch.ops.tables import crc_bytes_tables, crc_nseg
    from t3fs_torch.ops.torch_codec import i32

    L = rows.shape[1]
    tables = crc_bytes_tables(crc_nseg(L), rows.device)
    raw = torch.cat([cc.crc_bytes_raw_plain(part, tables) for part in rows.split(group)])
    return raw ^ i32(default_matrices().affine_const(L))


def rand_bytes(g: torch.Generator, dev: torch.device, *shape: int) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)


def phase_crc_bytes(dev: torch.device, g: torch.Generator) -> int:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import (
        crc_bytes_tables, crc_nseg, decode_tables, encode_map_tables)

    errs = {}
    t1 = crc_bytes_tables(1, dev)
    segs = rand_bytes(g, dev, 4096, 512)
    errs["seg"] = max_abs_err(cc.crc_seg_bytes(segs, t1), cc.crc_seg_bytes_plain(segs, t1))
    log(f"[11] crc_seg_bytes (4096, 512): max_abs_err={errs['seg']}")
    subset = sorted({0, CHUNKS // 3, CHUNKS - 1})
    for L in (CHUNK_BYTES, CHUNK_BYTES - 5, ODD_CHUNK):
        rows = rand_bytes(g, dev, CHUNKS, L)
        tables = crc_bytes_tables(crc_nseg(L), dev)
        e = max_abs_err(cc.crc_bytes_raw(rows, tables)[subset],
                        cc.crc_bytes_raw_plain(rows[subset], tables))
        log(f"[11] crc_bytes_raw ({CHUNKS}, {L}): max_abs_err={e} on rows {subset} "
            f"(row r starts at byte r * {L}{': unaligned' if L % 16 else ''}; "
            f"runs a row: {cc.crc_bytes_runs(crc_nseg(L))}, the first of "
            f"{crc_nseg(L) % 16 or 16} segments)")
        errs[L] = e
    # rows at every offset 0..15 from a 16-byte boundary: views into one buffer
    L = ODD_CHUNK
    tables = crc_bytes_tables(crc_nseg(L), dev)
    flat = rand_bytes(g, dev, 4 * L + 16)
    e = 0
    for off in range(16):
        view = flat[off:off + 4 * L].view(4, L)
        e = max(e, max_abs_err(cc.crc_bytes_raw(view, tables),
                               cc.crc_bytes_raw_plain(view.contiguous(), tables)))
    log(f"[11] crc_bytes_raw (4, {L}) views at base offsets 0..15: max_abs_err={e}")
    errs["offsets"] = e
    del flat, rows
    rng = np.random.default_rng(SEED + 11)
    for n in (1, 9, 513, (129 << 10) + 3):
        p = rng.bytes(n)
        row = torch.frombuffer(bytearray(p), dtype=torch.uint8).reshape(1, n).to(dev)
        crc = int(u32(cc.make_crc32c_bytes(n, dev)(row)).item())
        errs[n] = abs(crc - crc32c_ref(p))
        log(f"[11] crc32c of {n} bytes: {crc:#010x}, crc32c_ref {crc32c_ref(p):#010x}")

    rs63 = default_rs(K63, M63)
    n, L = STRIPES, SHARD_BYTES
    shards = rand_bytes(g, dev, n, K63, L)
    parity, crcs = cc.make_stripe_encode_step_fast(L, K63, M63, dev)(shards)
    plain_par = cc.rs_bitmatmul_plain(shards, encode_map_tables(rs63, dev))
    plain_crc = torch.cat([plain_crc_bytes(shards.reshape(n * K63, L)).reshape(n, K63),
                           plain_crc_bytes(plain_par.reshape(n * M63, L)).reshape(n, M63)],
                          dim=1)
    errs["encode step"] = max(max_abs_err(parity, plain_par), max_abs_err(crcs, plain_crc))
    present = present_of(LOST63, K63 + M63, K63)
    full = torch.cat([shards, parity], dim=1)
    rows = full[:, list(present)].contiguous()
    rebuilt, dcrcs = cc.make_stripe_decode_step_bytes(L, present, LOST63, K63, M63, dev)(rows)
    plain_reb = cc.rs_bitmatmul_plain(rows, decode_tables(present, LOST63, rs63, dev))
    want_crc = plain_crc[:, list(present + LOST63)]
    errs["decode step"] = max(max_abs_err(rebuilt, plain_reb),
                              max_abs_err(rebuilt, full[:, list(LOST63)]),
                              max_abs_err(dcrcs, want_crc))
    log(f"[11] byte steps RS({K63}+{M63}) at ({n}, {K63}, {L}): encode (B5 + B6) and "
        f"decode want={LOST63} (B5 + B6) against plain: max_abs_err "
        f"{errs['encode step']} / {errs['decode step']}")
    worst = max(errs.values())
    expect(worst == 0, f"B6 or a byte step disagrees with plain: {errs}")
    return worst


# --- phase 12: the byte-path EC routes --------------------------------------

def add_launches(total: dict, part: dict) -> None:
    for name, v in part.items():
        total[name] = total.get(name, 0) + v


async def phase_byte_routes(dev: torch.device) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.codec import crc32c_combine
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rng = np.random.default_rng(SEED + 12)
    codec = TorchECCodec(device=dev)
    total: dict[str, int] = {}

    async def run(label: str, calls):
        cc.reset_launches()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*calls)
        wall = time.perf_counter() - t0
        launches = dict(cc.launches)
        add_launches(total, launches)
        log(f"[12] {label}: wall {wall:.3f} s (first call's table build included), "
            f"launches={launches}")
        return outs, launches

    # RS(6+3) stripe writes: B5 + B6
    data = [rng.integers(0, 256, (K63, SHARD_BYTES), dtype=np.uint8) for _ in range(24)]
    outs, launches = await run(f"24 concurrent encode_verified RS({K63}+{M63}) at "
                               f"{SHARD_BYTES >> 10} KiB",
                               [codec.encode_verified(d, K63, M63) for d in data])
    expect(launches["rs_bitmatmul"] > 0 and launches["crc_bytes"] > 0,
           "RS(6+3) writes must launch B5 and B6")
    full63 = np.stack([np.concatenate([d, o[0]]) for d, o in zip(data, outs)])
    enc = make_rs_encode_matmul(default_rs(K63, M63), dev)      # independent of B5
    want_par = torch.cat([enc(torch.from_numpy(full63[i:i + 4, :K63]).to(dev)).cpu()
                          for i in range(0, len(data), 4)]).numpy()
    crcs63 = plain_shard_crcs(full63, dev)                      # plain B1
    bad_par = int((full63[:, K63:] != want_par).any(axis=(1, 2)).sum())
    bad_crc = sum(not np.array_equal(o[1], c) for o, c in zip(outs, crcs63))
    log(f"[12] RS({K63}+{M63}) writes: wrong parity stripes {bad_par}, wrong CRC "
        f"rows {bad_crc} (parity by the plain bit-matmul, CRCs by plain B1)")
    expect(bad_par == 0 and bad_crc == 0, "RS(6+3) writes disagree")

    # RS(6+3) degraded reads losing three shards: B5 + B6
    present = present_of(LOST63, K63 + M63, K63)
    reqs = list(range(12))
    outs, launches = await run(
        f"12 concurrent reconstruct_verified RS({K63}+{M63}) want={LOST63}",
        [codec.reconstruct_verified(np.ascontiguousarray(full63[i, list(present)]),
                                    present, LOST63, K63, M63) for i in reqs])
    expect(launches["rs_bitmatmul"] > 0 and launches["crc_bytes"] > 0,
           "RS(6+3) reads must launch B5 and B6")
    bad = sum(not (np.array_equal(r, full63[i, list(LOST63)])
                   and np.array_equal(c, crcs63[i, list(present + LOST63)]))
              for i, (r, c) in zip(reqs, outs))
    log(f"[12] RS({K63}+{M63}) degraded reads: wrong stripes or CRC rows {bad}")
    expect(bad == 0, "RS(6+3) degraded reads disagree")

    # RAID-6 writes at a length that is not whole segments: B2 + B6
    L6 = ODD_CHUNK
    data = [rng.integers(0, 256, (K, L6), dtype=np.uint8) for _ in range(STRIPES)]
    outs, launches = await run(f"{STRIPES} concurrent encode_verified RS({K}+{M}) at "
                               f"{L6} bytes",
                               [codec.encode_verified(d, K, M) for d in data])
    expect(launches["rs_raid6_words"] > 0 and launches["crc_bytes"] > 0,
           "RAID-6 writes at odd lengths must launch B2 and B6")
    full6 = np.stack([np.concatenate([d, o[0]]) for d, o in zip(data, outs)])
    words = torch.from_numpy(full6[:, :K].copy().view(np.int32)).to(dev)
    from t3fs_torch.ops.tables import codec_tables

    want_par = cc.rs_raid6_words_plain(words, codec_tables(1, K, M, device=dev))
    bad_par = max_abs_err(torch.from_numpy(full6[:, K:].copy().view(np.int32)).to(dev),
                          want_par)
    crcs6 = plain_crc_bytes(torch.from_numpy(full6).to(dev).reshape(-1, L6)
                            ).cpu().numpy().view(np.uint32).reshape(STRIPES, K + M)
    bad_crc = sum(not np.array_equal(o[1], c) for o, c in zip(outs, crcs6))
    log(f"[12] RAID-6 writes at {L6} bytes: parity max_abs_err={bad_par} (plain B2), "
        f"wrong CRC rows {bad_crc} (plain B6)")
    expect(bad_par == 0 and bad_crc == 0, "RAID-6 odd-length writes disagree")

    # repair at sub-shards that are not whole segments: B4 + B6
    slots, coeffs = repair_plan(LOST_SLOT)
    sub = L6 // SUBSHARDS
    chunks = STRIPES // 2                  # 6 chunks x 4 sub-shards: 24 calls
    jobs = [np.ascontiguousarray(full6[i, slots, q * sub:(q + 1) * sub])
            for i in range(chunks) for q in range(SUBSHARDS)]
    outs, launches = await run(f"{len(jobs)} repair calls at {sub}-byte sub-shards "
                               f"of slot {LOST_SLOT}",
                               [codec.repair(rows, coeffs, K, M) for rows in jobs])
    expect(launches["repair_words"] > 0 and launches["crc_bytes"] > 0,
           "odd-length repair must launch B4 and B6")
    bad = 0
    for i in range(chunks):
        parts = outs[i * SUBSHARDS:(i + 1) * SUBSHARDS]
        crc = int(parts[0][1])
        for _p, c in parts[1:]:
            crc = crc32c_combine(crc, int(c), sub)
        ok = (np.array_equal(np.concatenate([p for p, _c in parts]), full6[i, LOST_SLOT])
              and crc == int(crcs6[i, LOST_SLOT]))
        bad += not ok
    log(f"[12] odd-length repair: wrong chunks or stitched CRCs {bad}; "
        f"codec_counts={codec.codec_counts}")
    expect(bad == 0, "odd-length repairs disagree")
    await codec.close()
    expect_routes(codec, ("cuda-encode-bytes", "cuda-decode-bytes",
                          "cuda-repair-words-odd"))
    return total


# --- phase 13: PM-MSR -------------------------------------------------------

async def phase_msr(dev: torch.device) -> dict:
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.msr import default_msr

    code = default_msr(K, M)
    L = SHARD_BYTES
    sub = L // code.alpha
    rng = np.random.default_rng(SEED + 13)
    data = [rng.integers(0, 256, (K, L), dtype=np.uint8) for _ in range(24)]
    codec = TorchECCodec(device=dev)
    codec.warmup_msr([LOST_SLOT], L, K, M, batch_sizes=(24,))
    total: dict[str, int] = {}

    async def run(label: str, calls):
        cc.reset_launches()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*calls)
        wall = time.perf_counter() - t0
        launches = dict(cc.launches)
        add_launches(total, launches)
        log(f"[13] {label}: wall {wall:.3f} s, launches={launches}")
        return outs, launches

    outs, launches = await run(f"24 concurrent msr_encode_verified RS({K}+{M}) pm-msr "
                               f"at {L >> 10} KiB (after warmup_msr)",
                               [codec.msr_encode_verified(d, K, M) for d in data])
    expect(launches["rs_raid6_words"] > 0 and launches["crc_words"] > 0,
           "pm-msr writes must launch B2 and B1")
    stored = np.stack([np.concatenate([d, o[0]]) for d, o in zip(data, outs)])
    crcs = plain_shard_crcs(stored, dev)                          # plain B1
    bad_crc = sum(not np.array_equal(o[1], c) for o, c in zip(outs, crcs))
    expect(np.array_equal(outs[0][0], code.encode_np(data[0])),
           "pm-msr stripe 0 parity != encode_np")
    log(f"[13] pm-msr writes: stripe 0 parity == encode_np; wrong CRC rows {bad_crc}")
    expect(bad_crc == 0, "pm-msr write CRCs disagree")

    sch = code.schedule(LOST_SLOT)
    helpers = [np.ascontiguousarray(
        stored[i, list(sch.helpers)].reshape(code.d, code.alpha, sub)[:, list(sch.selected)]
        .reshape(code.d, -1)) for i in range(len(data))]
    outs, launches = await run(f"{len(helpers)} msr_repair of slot {LOST_SLOT} over "
                               f"({code.d}, {helpers[0].shape[1] >> 10} KiB) helpers",
                               [codec.msr_repair(h, LOST_SLOT, K, M) for h in helpers])
    expect(launches["repair_words"] > 0 and launches["crc_words"] > 0,
           "pm-msr repair must launch B4 and B1")
    expect(np.array_equal(outs[0][0], code.repair_np(
        LOST_SLOT, helpers[0].reshape(code.d, sch.npl, sub))), "repair 0 != repair_np")
    bad = sum(not (np.array_equal(o, stored[i, LOST_SLOT]) and int(c) == int(crcs[i, LOST_SLOT]))
              for i, (o, c) in enumerate(outs))
    log(f"[13] pm-msr repair: chunk 0 == repair_np; wrong chunks or CRCs {bad} "
        "(every chunk against the stored shard, which parity errors would break)")
    expect(bad == 0, "pm-msr repairs disagree")

    jobs = [(i, MSR_LOSSES[i % len(MSR_LOSSES)]) for i in range(6)]
    outs, launches = await run(
        f"6 msr_decode_verified losing {MSR_LOSSES}",
        [codec.msr_decode_verified(np.ascontiguousarray(stored[i, list(present_of(lost, K + M, K))]),
                                   present_of(lost, K + M, K), lost, K, M)
         for i, lost in jobs])
    expect(launches["crc_words"] > 0, "pm-msr decode must launch B1")
    p0 = present_of(MSR_LOSSES[0], K + M, K)
    expect(np.array_equal(outs[0][0], code.decode_np(p0, stored[0, list(p0)], MSR_LOSSES[0])),
           "decode 0 != decode_np")
    bad = sum(not (np.array_equal(r, stored[i, list(lost)])
                   and np.array_equal(c, crcs[i, list(present_of(lost, K + M, K) + lost)]))
              for (i, lost), (r, c) in zip(jobs, outs))
    log(f"[13] pm-msr decode: stripe 0 == decode_np; wrong stripes or CRC rows {bad}; "
        f"codec_counts={codec.codec_counts}")
    expect(bad == 0, "pm-msr decodes disagree")
    await codec.close()
    expect_routes(codec, ("cuda-msr-encode", "cuda-msr-repair", "cuda-msr-decode"))
    return total


# --- phase 17: codes past one kernel launch ----------------------------------

# RAID-6 at k = 40 and k = 254 (the most RAID-6 takes), RS(12+12) and
# RS(28+8): B3 past k = 32 runs B5, B5 past 8 output shards or 227 KiB of
# tables runs as several tiles, B4 past 32 helpers as several groups.  Shards
# of 1 MiB, 256 KiB at k = 254 (a 64 MiB stripe).
BIG_CODES = ((40, 2, SHARD_BYTES), (254, 2, SHARD_BYTES // 4),
             (12, 12, SHARD_BYTES), (28, 8, SHARD_BYTES))
# a data shard lost, then two shards (data and parity, or two data)
BIG_LOSSES = {(40, 2): ((5,), (0, 41)), (254, 2): ((200,), (3, 254)),
              (12, 12): ((11,), (0, 13)), (28, 8): ((27,), (4, 30))}


def phase_big_kernels(dev: torch.device, g: torch.Generator) -> dict[str, int]:
    """B5's tiles (RAID-6 k = 254 decode: two input groups; RS(12+12)
    encode: two row groups; RS(28+8) decode: one 56 KiB tile), B3's wrapper
    at k = 40 (B5 on the byte view) and B4 over 40 helpers (two groups)
    against their plain versions, at 2 stripes of 64 KiB shards."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.repair_program import schedule_repair_program
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import decode_tables, encode_map_tables, repair_tables

    L = 64 << 10
    errs = {"rs_bitmatmul": 0, "repair_words": 0}
    for label, gmap in (
            ("RAID-6 k=254 decode want=(2, 255)", decode_tables(
                (0, 1, *range(3, 255)), (2, 255), default_rs(254, 2), dev)),
            ("RS(12+12) encode", encode_map_tables(default_rs(12, 12), dev)),
            ("RS(28+8) decode of 8", decode_tables(
                tuple(range(4, 32)), (0, 1, 2, 3, 32, 33, 34, 35), default_rs(28, 8), dev))):
        shards = rand_bytes(g, dev, 2, gmap.k, L)
        e = max_abs_err(cc.rs_bitmatmul(shards, gmap), cc.rs_bitmatmul_plain(shards, gmap))
        log(f"[17] rs_bitmatmul {label} in {len(gmap.tiles)} tile(s) at (2, {gmap.k}, {L}): "
            f"max_abs_err={e}")
        errs["rs_bitmatmul"] = max(errs["rs_bitmatmul"], e)
    rs = default_rs(40, 2)
    present = (*range(1, 40), 41)
    dec = decode_tables((*range(1, 39), 40, 41), (0, 39), rs, dev)
    words = rand_words(g, dev, 2, 40, L // 4)
    e = max_abs_err(cc.rs_reconstruct_words(words, dec),
                    cc.rs_reconstruct_words_plain(words, dec))
    log(f"[17] rs_reconstruct_words RAID-6 k=40 (B5 on the byte view) at (2, 40, "
        f"{L // 4}): max_abs_err={e}")
    errs["rs_bitmatmul"] = max(errs["rs_bitmatmul"], e)
    row = rs.reconstruct_gfmatrix(list(present), [0])[0]
    rep = repair_tables(schedule_repair_program(tuple(int(c) for c in row)), rs)
    e = max_abs_err(cc.repair_words(words, rep), cc.repair_words_plain(words, rep))
    log(f"[17] repair_words over 40 helpers in {len(rep.groups)} groups at (2, 40, "
        f"{L // 4}): max_abs_err={e}")
    errs["repair_words"] = e
    expect(max(errs.values()) == 0, f"tiled B5 / grouped B4 disagree with plain: {errs}")
    return errs


async def phase_big_codes(dev: torch.device) -> dict:
    """The EC routes at the codes of BIG_CODES: encode_verified, reconstruct
    and reconstruct_verified of one and two lost shards, and at RAID-6 k =
    40 a repair over 40 helpers; 2 stripes a code.  Parity against the plain
    PyTorch bit-matmul (its first 64 KiB of stripe 0 against
    RSCode.encode_ref), every rebuilt shard against the stripe, every CRC
    against plain B1."""
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rng = np.random.default_rng(SEED + 17)
    codec = TorchECCodec(device=dev)
    stripes = {}
    for k, m, L in BIG_CODES:
        data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
        parity = make_rs_encode_matmul(default_rs(k, m), dev)(
            torch.from_numpy(data).to(dev)).cpu().numpy()
        head = 64 << 10           # byte positions are independent: RSCode on a slice
        expect(np.array_equal(parity[0, :, :head],
                              default_rs(k, m).encode_ref(data[0, :, :head])),
               f"RS({k}+{m}) stripe 0: plain bit-matmul != RSCode.encode_ref")
        full = np.concatenate([data, parity], axis=1)
        stripes[k, m] = (full, plain_shard_crcs(full, dev))
    rs40 = default_rs(40, 2)
    helpers = (*range(1, 40), 41)
    coeffs = tuple(int(c) for c in rs40.reconstruct_gfmatrix(list(helpers), [0])[0])

    calls, checks = [], []
    for (k, m), (full, crcs) in stripes.items():
        for i in range(2):
            calls.append(codec.encode_verified(full[i, :k], k, m))
            checks.append((full[i, k:], crcs[i]))
            for lost in BIG_LOSSES[k, m]:
                present = present_of(lost, k + m, k)
                rows = np.ascontiguousarray(full[i, list(present)])
                calls.append(codec.reconstruct_verified(rows, present, lost, k, m))
                checks.append((full[i, list(lost)], crcs[i, list(present + lost)]))
                calls.append(codec.reconstruct(rows, present, lost, k, m))
                checks.append((full[i, list(lost)], None))
            if (k, m) == (40, 2):
                calls.append(codec.repair(np.ascontiguousarray(full[i, list(helpers)]),
                                          coeffs, k, m))
                checks.append((full[i, 0], crcs[i, 0]))
    cc.reset_launches()
    t0 = time.perf_counter()
    outs = await asyncio.gather(*calls)
    wall = time.perf_counter() - t0
    launches = dict(cc.launches)
    await codec.close()
    bad = 0
    for out, (want, want_crc) in zip(outs, checks):
        got, crc = (out, None) if want_crc is None else out
        bad += not np.array_equal(got, want)
        if want_crc is not None:
            bad += not np.array_equal(np.asarray(crc, dtype=np.uint32), want_crc)
    log(f"[17] codes past one launch, RAID-6 k=40 and k=254, RS(12+12), RS(28+8): "
        f"{len(calls)} concurrent calls, {codec.batches} groups, codec_counts="
        f"{codec.codec_counts}, launches={launches}, wall {wall:.3f} s (first use of "
        f"each code's tables included); wrong results {bad}")
    expect(bad == 0, "codes past one launch disagree")
    expect_routes(codec, ("cuda-encode-words", "cuda-decode-words", "cuda-rec-words",
                          "cuda-repair-words", "cuda-encode-bytes", "cuda-decode-bytes",
                          "cuda-bitmatmul"))
    expect(launches["rs_bitmatmul"] > 0 and launches["repair_words"] > 0
           and launches["crc_words"] > 0 and launches["crc_bytes"] > 0,
           "codes past one launch must launch B5, B4, B1 and B6")
    return launches


# --- phase 14: byte-path and PM-MSR times -----------------------------------

def phase_byte_times(dev: torch.device, g: torch.Generator, b1: dict) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops import msr_codec as mc
    from t3fs_torch.ops.msr import default_msr
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import crc_bytes_tables, crc_nseg, encode_map_tables

    out = {}
    for label, L in B6_SHAPES:
        rows = rand_bytes(g, dev, CHUNKS, L)
        tables = crc_bytes_tables(crc_nseg(L), dev)
        out[f"crc_bytes {label}"] = {
            **kernel_times(lambda: cc.crc_bytes_raw(rows, tables)),
            "plain_ms": time_ms(lambda: cc.crc_bytes_raw_plain(rows, tables), 2, 1),
            "bound_ms": (rows.numel() + 4 * CHUNKS) / HBM_BYTES_PER_S * 1e3,
            "shape": f"({CHUNKS}, {L}) u8",
        }
        del rows
    log(f"[14] B1 (crc_words) at the bytes of 64 x 4 MiB, from phase 5: "
        f"{b1['ms'] * 1e3:.1f} us")

    rs63 = default_rs(K63, M63)
    shards = rand_bytes(g, dev, STRIPES, K63, SHARD_BYTES)
    step = cc.make_stripe_encode_step_fast(SHARD_BYTES, K63, M63, dev)
    enc = encode_map_tables(rs63, dev)

    def plain_step():
        par = cc.rs_bitmatmul_plain(shards, enc)
        plain_crc_bytes(shards.reshape(-1, SHARD_BYTES), group=1 << 30)
        plain_crc_bytes(par.reshape(-1, SHARD_BYTES), group=1 << 30)

    out[f"byte encode step RS({K63}+{M63})"] = {
        **kernel_times(lambda: step(shards)),
        "plain_ms": time_ms(plain_step, 2, 1),
        "bound_ms": (K63 + M63) * SHARD_BYTES * STRIPES / HBM_BYTES_PER_S * 1e3,
        "shape": f"({STRIPES}, {K63}, {SHARD_BYTES}) u8",
    }
    # its launches called from the host can outlast the card's work: the
    # same step replayed from a CUDA graph
    out[f"byte encode step RS({K63}+{M63}), CUDA graph"] = {
        **out[f"byte encode step RS({K63}+{M63})"],
        **graph_kernel_times(lambda: step(shards)),
    }
    del shards

    code = default_msr(K, M)
    n, beta_len = 24, SHARD_BYTES // 2
    helpers = rand_bytes(g, dev, n, code.d, beta_len)
    step = mc.make_msr_repair_step(code, LOST_SLOT, SHARD_BYTES, dev)

    def plain_rows(chunk_len, device):
        from t3fs_torch.ops.tables import codec_tables
        from t3fs_torch.ops.torch_codec import i32

        t = codec_tables(chunk_len // 512, device=device)
        return lambda r: cc.crc_words_raw_plain(r.view(torch.int32), t) ^ i32(t.chunk_affine)

    def with_plain_kernels(fn):
        """Run fn with the step's B4 and B1 swapped for their plain versions."""
        kernels = (cc.repair_words, mc.make_crc32c_rows)
        cc.repair_words, mc.make_crc32c_rows = cc.repair_words_plain, plain_rows
        try:
            return fn()
        finally:
            cc.repair_words, mc.make_crc32c_rows = kernels

    plain = with_plain_kernels(
        lambda: mc.make_msr_repair_step(code, LOST_SLOT, SHARD_BYTES, dev))
    out[f"msr repair step slot {LOST_SLOT}"] = {
        **kernel_times(lambda: step(helpers)),
        "plain_ms": time_ms(lambda: with_plain_kernels(lambda: plain(helpers)), 2, 1),
        "bound_ms": n * (code.d * beta_len + SHARD_BYTES) / HBM_BYTES_PER_S * 1e3,
        "shape": f"({n}, {code.d}, {beta_len}) u8 -> ({n}, {SHARD_BYTES})",
    }
    log_times(14, out)
    return out


# --- phase 16: H1, the headline bench and the decode bench -------------------

def run_captured(main, argv: list[str], phase: int = 16) -> tuple[int, list[str]]:
    """A bench's main(argv) in this process: its lines echoed under the
    phase's tag, its exit code and its lines returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"[{phase}] {line}")
    return rc, lines


def h1_against_add(x: torch.Tensor) -> float:
    """H1 against torch.add(x, 1) where the card's clocks cannot drift
    between the two: 20 calls of each captured in a CUDA graph, replayed in
    turns H1, add, H1, add, ...  Returns H1's median over torch.add's."""
    from t3fs_torch.benchmarks import devbench as db

    pair = db.interleaved_graph_samples(
        {"H1": lambda: db.make_copy3d(x), "torch.add": lambda: torch.add(x, 1)},
        20, 2 * REPEATS)
    med = {name: v[len(v) // 2] for name, v in pair.items()}
    ratio = med["H1"] / med["torch.add"]
    log(f"[16] copy3d against torch.add, interleaved CUDA-graph replays of 20 "
        f"calls, {2 * REPEATS} samples each: H1 {med['H1'] * 1e3:.2f} us (min "
        f"{pair['H1'][0] * 1e3:.2f}, max {pair['H1'][-1] * 1e3:.2f}), torch.add "
        f"{med['torch.add'] * 1e3:.2f} us (min {pair['torch.add'][0] * 1e3:.2f}, "
        f"max {pair['torch.add'][-1] * 1e3:.2f}); H1 / torch.add {ratio:.4f}")
    return ratio


def phase_bench(dev: torch.device, g: torch.Generator) -> tuple[int, dict, dict]:
    from t3fs_torch import bench
    from t3fs_torch.benchmarks import devbench as db
    from t3fs_torch.benchmarks import ec_recovery_bench as ecb
    from t3fs_torch.ops import cuda_codec as cc

    x = rand_words(g, dev, STRIPES, K, SHARD_BYTES // 4)
    x.view(-1)[:2] = torch.tensor([-1, 2**31 - 1], dtype=torch.int32, device=dev)
    ragged = rand_words(g, dev, 3, 5, 1001)
    unaligned = rand_words(g, dev, 3 * 5 * 1001 + 1)[1:].view(3, 5, 1001)
    e = 0
    for label, t in (("the bench's shape, with both wraps", x), ("ragged", ragged),
                     ("ragged, 4 bytes off alignment", unaligned),
                     ("one vector and a tail", rand_words(g, dev, 1, 1, 7))):
        et = max_abs_err(db.make_copy3d(t), db.copy3d_plain(t))
        log(f"[16] copy3d {tuple(t.shape)} ({label}): max_abs_err={et}")
        e = max(e, et)
    expect(e == 0, f"H1 disagrees with its plain version (max_abs_err={e})")
    one = db.chained_timer(db.make_copy3d, x, 5)
    log(f"[16] a chained copy3d pass captured as a CUDA graph gives the eager "
        f"pass's acc; 5 iterations in {one() * 1e3:.3f} ms")

    nbytes = x.numel() * 4
    t = {**kernel_times(lambda: db.make_copy3d(x)),
         "plain_ms": kernel_times(lambda: db.copy3d_plain(x))["ms"],
         "library_ms": kernel_times(lambda: torch.add(x, 1))["ms"],
         "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"[16] copy3d ({STRIPES}, {K}, {SHARD_BYTES // 4}): {t['ms'] * 1e3:.1f} us, "
        f"median of {REPEATS} (min {t['min_ms'] * 1e3:.1f}, max {t['max_ms'] * 1e3:.1f}) "
        f"(bound {t['bound_ms'] * 1e3:.1f} us by bytes at 3.35 TB/s, "
        f"{t['bound_ms'] / t['ms'] * 100:.1f}% of it; {2 * nbytes / t['ms'] / 1e6:.1f} "
        f"GB/s r+w); plain {t['plain_ms'] * 1e3:.1f} us; library call torch.add "
        f"{t['library_ms'] * 1e3:.1f} us")
    h1_against_add(x)

    cc.reset_launches()
    db.reset_launches()
    rc, lines = run_captured(bench.main, ["--quick"])
    launches = {"copy3d": db.launches["copy3d"]}
    res = json.loads(lines[-1])
    log(f"[16] bench --quick: exit {rc}; its launches: copy3d {launches['copy3d']}, "
        f"codec {dict(cc.launches)}")
    expect(rc == 0 and res["value"] > 0, f"the bench failed: {lines[-1]}")
    expect(res["device"] == torch.cuda.get_device_name(0), "the bench line names no card")
    expect(launches["copy3d"] > 0, "the bench must launch H1")

    rc, lines = run_captured(ecb.main, ["--chunk-size", str(SHARD_BYTES), "--decode-batch",
                                        str(STRIPES), "--decode-ab", "--json"])
    expect(rc == 0, f"the decode bench failed: {lines[-1]}")
    rates = {k: v for k, v in json.loads(lines[0])["decode_microbench"].items()
             if k.endswith("_GB_s")}
    metric = json.loads(lines[-1])["decode_metric"]
    expect(len(rates) == 3 and min(rates.values()) > 0
           and metric[f"rs{K}+{M}_reconstruct_GB_s"] > 0,
           f"the decode bench gave no fused, word and byte-plane rates: {rates}")
    return e, t, launches


# --- phase 18: the device sort ------------------------------------------------

def phase_sort() -> None:
    from t3fs_torch.benchmarks import sort_bench as sb
    from t3fs_torch.ops.device_sort import KEY_LEN, lexsort_rows, make_device_sorter

    rows = sb.gensort_rows(SORT_RECORDS)
    res = sb.measure(rows)
    log(f"[18] device sort of {SORT_RECORDS} gensort rows (seed {sb.SEED}), "
        f"make_device_sorter and sort_columns both equal to lexsort_rows: sort "
        f"{res['sort_ms']:.3f} ms, median of 5 (bound {res['bound_ms']:.3f} ms by "
        f"bytes at 3.35 TB/s, {res['bound_ms'] / res['sort_ms'] * 100:.1f}% of it; "
        f"{res['records_per_s'] / 1e6:.1f} M records/s, {res['key_MB_s']:.0f} key "
        f"MB/s); H2D of the int64 columns {res['h2d_ms']:.3f} ms, D2H of the "
        f"permutation {res['d2h_ms']:.3f} ms; host: columns "
        f"{res['host_columns_ms']:.1f} ms, gather of the rows {res['gather_ms']:.1f} "
        f"ms, np.lexsort {res['lexsort_ms']:.1f} ms; make_device_sorter end to end "
        f"{res['sorter_wall_ms']:.1f} ms")
    sort_perm = make_device_sorter()
    ff = rows[:4096].copy()
    ff[::3, :KEY_LEN] = 0xFF
    for label, r in [(f"n={n}", rows[:n]) for n in (0, 1, 1023, 1025)] + [
            ("4096 rows, every third key all 0xFF", ff)]:
        perm = sort_perm(r)
        expect(perm.dtype == (np.int64 if len(r) == 0 else np.int32)
               and np.array_equal(perm, lexsort_rows(r)),
               f"the device sort differs from lexsort_rows at {label}")
    ff_rows = np.arange(0, len(ff), 3)
    expect(np.array_equal(sort_perm(ff)[-len(ff_rows):], ff_rows),
           "the all-0xFF keys must sort last, in row order")
    log("[18] n = 0, 1, 1023, 1025 and 4096 rows with all-0xFF keys: equal to "
        "lexsort_rows")
    del rows, ff
    rc, lines = run_captured(sb.main, ["--quick"], phase=18)
    expect(rc == 0 and json.loads(lines[-1])["perm_equals_lexsort"],
           f"the sort bench failed: {lines[-1]}")


# --- phase 19: the codec mesh ---------------------------------------------------

def phase_mesh(dev: torch.device) -> dict:
    """The 2 x 2 mesh (4 ranks) at the stripe bench's width, every output
    against the unsharded steps on the card, on graft_entry's backend for
    the box's card count; logs each rank's step times beside its kernels'
    and its CRC combine's alone; returns the ranks' summed launches of the
    counted run."""
    from t3fs_torch import graft_entry as ge
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.crc32c import crc32c_ref
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.torch_codec import make_rs_encode_matmul

    rng = np.random.default_rng(SEED + 19)
    stripes = rng.integers(0, 256, (MESH_STRIPES, K, SHARD_BYTES), dtype=np.uint8)
    data63 = rng.integers(0, 256, (MESH_STRIPES, K63, SHARD_BYTES), dtype=np.uint8)
    W = SHARD_BYTES // 4
    x = torch.from_numpy(stripes.view(np.int32)).to(dev)
    parity, crcs = cc.make_stripe_encode_step_words(W, device=dev)(x)
    full = torch.cat([x, parity], dim=1)
    ref = {"parity": parity.cpu().numpy().view(np.uint32),
           "crcs": crcs.cpu().numpy().view(np.uint32)}
    for want in MESH_WANTS:
        present = ge.present_of(want, K, M)
        rebuilt, rcrcs = cc.make_stripe_decode_step_words(W, present, want, device=dev)(
            full[:, list(present)].contiguous())
        ref[want] = (rebuilt.cpu().numpy().view(np.uint8),
                     rcrcs[:, K:].cpu().numpy().view(np.uint32))
    d63 = torch.from_numpy(data63).to(dev)
    full63 = torch.cat([d63, make_rs_encode_matmul(default_rs(K63, M63), dev)(d63)],
                       dim=1)
    present63 = ge.present_of(ge.LOST63, K63, M63)
    surv63 = full63[:, list(present63)].contiguous()
    rebuilt63, c63 = cc.make_stripe_decode_step_bytes(
        SHARD_BYTES, present63, ge.LOST63, K63, M63, dev)(surv63)
    expect(torch.equal(rebuilt63, full63[:, list(ge.LOST63)]),
           "the unsharded RS(6+3) decode does not give back the lost shards")
    ref63 = (rebuilt63.cpu().numpy(), c63[:, K63:].cpu().numpy().view(np.uint32))
    surv63 = surv63.cpu().numpy()
    del x, parity, crcs, full, rebuilt, rcrcs, d63, full63, rebuilt63, c63
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = ge.run_mesh(MESH_RANKS, stripes, surv63, MESH_WANTS, dp=MESH_DP,
                      device=dev, timed=True, timeout_s=600)
    wall = time.perf_counter() - t0
    log(f"[19] mesh dp x cp = {res['dp']} x {res['cp']}, {MESH_STRIPES} x RS({K}+{M}) "
        f"stripes of {SHARD_BYTES >> 20} MiB shards: backend {res['backend']}, "
        f"{res['ranks_per_card']} rank(s) a card on {torch.cuda.device_count()} "
        f"card(s) in the box; spawn to join {wall:.1f} s")
    out = res["outputs"]
    pairs = [("enc_parity", ref["parity"].view(np.uint8)), ("enc_crcs", ref["crcs"]),
             ("wenc_parity", ref["parity"]), ("wenc_crcs", ref["crcs"]),
             ("wrec63", ref63[0]), ("wrec63_crcs", ref63[1])]
    for want in MESH_WANTS:
        t = ge.want_tag(want)
        pairs += [(f"rec{t}", ref[want][0]), (f"rec{t}_crcs", ref[want][1]),
                  (f"wrec{t}", ref[want][0]), (f"wrec{t}_crcs", ref[want][1])]
    for name, want_arr in pairs:
        expect(out[name].shape == want_arr.shape and np.array_equal(out[name], want_arr),
               f"mesh output {name} differs from the unsharded step on the card")
    spot = [(out["enc_crcs"][0, 0], stripes[0, 0]),
            (out["wenc_crcs"][-1, K + 1], out["enc_parity"][-1, 1]),
            (out[f"wrec{ge.want_tag(MESH_WANTS[0])}_crcs"][1, 0], stripes[1, MESH_WANTS[0][0]]),
            (out["wrec63_crcs"][0, 0], out["wrec63"][0, 0])]
    for crc, shard_bytes in spot:
        expect(int(crc) == crc32c_ref(shard_bytes.tobytes()), "a mesh CRC != crc32c_ref")
    log(f"[19] every parity byte, rebuilt byte and CRC of {len(pairs)} outputs (byte "
        f"and word encode; byte and word decode of want {', '.join(map(str, MESH_WANTS))}; "
        f"RS({K63}+{M63}) word decode of want {ge.LOST63}) equal to the unsharded "
        f"steps on the card; {len(spot)} CRCs equal to crc32c_ref")
    launches: dict[str, int] = {}
    for r, meta in enumerate(res["ranks"]):
        add_launches(launches, meta["launches"])
        log(f"[19] rank {r} (dp {meta['dp_index']}, cp {meta['cp_index']}) on "
            f"{meta['device']}, {res['backend']}, {res['ranks_per_card']} rank(s) a "
            f"card, ms a call (CUDA events, 5 calls): " + ", ".join(
                f"{name} {ms:.3f}" for name, ms in meta["ms"].items()))
    log(f"[19] the ranks' launches in the counted run: {launches}")
    for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words", "rs_bitmatmul"):
        expect(launches.get(name, 0) > 0, f"the mesh did not launch {name}")
    return launches


# --- phase 20: the graft entry -----------------------------------------------

def phase_entry(dev: torch.device) -> dict:
    from t3fs_torch import graft_entry as ge
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.torch_codec import make_stripe_encode_step

    fn, (words,) = ge.entry(dev)
    cc.reset_launches()
    parity, crcs = fn(words)
    torch.cuda.synchronize()
    launches = dict(cc.launches)
    pparity, pcrcs = make_stripe_encode_step(words.shape[2] * 4, device=dev)(
        words.view(torch.uint8))
    e = max(max_abs_err(parity.view(torch.uint8), pparity), max_abs_err(crcs, pcrcs))
    log(f"[20] graft_entry.entry() on {tuple(words.shape)} words: launches {launches}; "
        f"parity and CRCs against the plain step: max_abs_err={e}")
    expect(e == 0 and launches["crc_words"] > 0 and launches["rs_raid6_words"] > 0,
           "entry() disagrees with the plain step or ran no kernel")
    return launches


# --- phase 21: the CRAQ chain write ------------------------------------------

def chain_mix(full_chunks: int) -> list[list[tuple]]:
    """Phase 3's size mix through StorageClient.write_chunk, in rounds (each
    round's writes run concurrently; a chunk's writes follow its rounds):
    (inode, chunk index, offset, length).  Inode 2: 1 MiB writes, then
    appends of 1 MiB, (129 << 10) + 3 and 40 000 B (crc_combine), then 1 MiB
    overwrites inside them; inode 3: (129 << 10) + 3 B writes; inode 4:
    40 000 B writes (the host path); then 1 MiB overwrites inside the big
    file's full chunks (inode 1), which recompute the chunk CRC on the host."""
    mib, odd = 1 << 20, (129 << 10) + 3
    return [
        [(2, i, 0, mib) for i in range(8)] + [(3, i, 0, odd) for i in range(4)]
        + [(4, i, 0, 40_000) for i in range(4)],
        [(2, i, mib, mib) for i in range(8)],
        [(2, i, 2 * mib, odd) for i in range(8)],
        [(2, i, 2 * mib + odd, 40_000) for i in range(8)],
        [(2, i, mib // 2, mib) for i in range(8)]
        + [(1, i, mib + 4096 * i, mib) for i in range(min(8, full_chunks))],
    ]


async def phase_chain(dev: torch.device, pipeline: str, file_bytes: int,
                      chunk_bytes: int) -> dict:
    """One pass of the CRAQ 3-replica chain write through the port's entry
    points: StorageFabric(3 nodes, 3 replicas), a CudaChecksumBackend per
    node on `dev`, the fabric's default native engine and io_uring reads,
    `pipeline`, StorageClient with inline transfers.  write_file_range of one seeded file, then chain_mix on
    fresh inodes; every byte read back; every replica's ChunkMeta against
    the native host CRC of the expected bytes (and full chunks against
    plain B1 on the card), update_ver == commit_ver; each node's backend
    batched exactly its device-size updates.  Returns the pass's launches."""
    from t3fs_torch.client.layout import FileLayout
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.ops import codec
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend)
    from t3fs_torch.storage.native_engine import NativeChunkEngine
    from t3fs_torch.storage.types import ChunkId
    from t3fs_torch.testing.fabric import StorageFabric

    expect(codec.host_impl() == "native", "the native host CRC did not build")
    rng = np.random.default_rng(SEED + 21)
    data = rng.bytes(file_bytes)
    fabric = StorageFabric(num_nodes=3, replicas=3,
                           checksum_backend=lambda: CudaChecksumBackend(device=dev),
                           write_pipeline=pipeline)
    await fabric.start()
    sc = StorageClient(lambda: fabric.routing, client=fabric.client)
    try:
        engines = [type(t.engine).__name__ for n in fabric.nodes
                   for t in n.targets.values()]
        log(f"[21] write_pipeline={pipeline}: target engines {engines}, io_uring "
            f"worker on nodes {[n.node_id for n in fabric.nodes if n.aio is not None]}")
        expect(all(isinstance(t.engine, NativeChunkEngine) for n in fabric.nodes
                   for t in n.targets.values()),
               f"[21] a target is not on the native engine: {engines}")
        lay = FileLayout(chunk_size=chunk_bytes, chains=[fabric.chain_id])
        big_chunks = -(-file_bytes // chunk_bytes)
        mix = chain_mix(file_bytes // chunk_bytes)
        sizes = sorted({chunk_bytes, *(n for rnd in mix for *_, n in rnd)})
        for node in fabric.nodes:
            await asyncio.to_thread(node.codec.warmup,
                                    [n for n in sizes if n >= DEFAULT_MIN_DEVICE_BYTES])

        cc.reset_launches()
        t0 = time.perf_counter()
        results = await sc.write_file_range(lay, inode=1, offset=0, data=data)
        wall = time.perf_counter() - t0
        launches_file = cc.launches["crc_words"]
        expect(all(r.status.code == 0 for r in results),
               f"[21] a chunk write failed: {[r.status for r in results if r.status.code][:3]}")
        t1 = time.perf_counter()
        expected = {(1, i): bytearray(data[i * chunk_bytes:(i + 1) * chunk_bytes])
                    for i in range(big_chunks)}
        updates = [len(p) for p in (expected[k] for k in sorted(expected))]
        for rnd in mix:
            payloads = [rng.bytes(n) for *_, n in rnd]
            res = await asyncio.gather(*(
                sc.write_chunk(fabric.chain_id, ChunkId(inode, idx), off, p,
                               chunk_size=chunk_bytes)
                for (inode, idx, off, _), p in zip(rnd, payloads)))
            expect(all(r.status.code == 0 for r in res),
                   f"[21] a mix write failed: {[r.status for r in res if r.status.code][:3]}")
            for (inode, idx, off, n), p in zip(rnd, payloads):
                buf = expected.setdefault((inode, idx), bytearray())
                if len(buf) < off:
                    buf.extend(bytes(off - len(buf)))
                buf[off:off + n] = p
                updates.append(n)
        mix_wall = time.perf_counter() - t1
        launches = dict(cc.launches)

        # the client's checksums alone, on the native host CRC
        t2 = time.perf_counter()
        for i in range(big_chunks):
            codec.crc32c(memoryview(data)[i * chunk_bytes:(i + 1) * chunk_bytes])
        host_crc_s = time.perf_counter() - t2

        got, _ = await sc.read_file_range(lay, 1, 0, file_bytes)
        expect(got == b"".join(expected[(1, i)] for i in range(big_chunks)),
               "[21] the file read back differs")
        for inode in (2, 3, 4):
            keys = sorted(k for k in expected if k[0] == inode)
            for (_, idx) in keys:
                got, _ = await sc.read_file_range(lay, inode, idx * chunk_bytes,
                                                  len(expected[(inode, idx)]))
                expect(got == expected[(inode, idx)],
                       f"[21] inode {inode} chunk {idx} read back differs")

        want_crc = {k: codec.crc32c(bytes(v)) for k, v in expected.items()}
        full = [k for k, v in sorted(expected.items()) if len(v) == chunk_bytes]
        b1 = dict(zip(full, plain_crcs([bytes(expected[k]) for k in full], dev)))
        for i, node in enumerate(fabric.nodes):
            engine = node.targets[fabric.target_id(i)].engine
            for (inode, idx), crc in want_crc.items():
                meta = engine.get_meta(ChunkId(inode, idx))
                expect(meta is not None and meta.checksum == crc
                       and b1.get((inode, idx), crc) == crc,
                       f"[21] node {i + 1} chunk {inode}.{idx}: stored "
                       f"{meta and meta.checksum:#x} != native {crc:#x}")
                expect(meta.update_ver == meta.commit_ver
                       and meta.length == len(expected[(inode, idx)]),
                       f"[21] node {i + 1} chunk {inode}.{idx} not committed")
            for (inode, idx) in [(1, 0), (2, 0), (4, 0)]:
                expect(engine.read(ChunkId(inode, idx)) == expected[(inode, idx)],
                       f"[21] node {i + 1} holds other bytes for {inode}.{idx}")
        device_updates = sum(n >= DEFAULT_MIN_DEVICE_BYTES for n in updates)
        per_node = [(n.codec.batches, n.codec.batched_items) for n in fabric.nodes]
        log(f"[21] CRAQ chain write, write_pipeline={pipeline}: {file_bytes >> 20} MiB "
            f"file in {big_chunks} x {chunk_bytes >> 20} MiB chunks over 3 replicas, "
            f"wall {wall:.3f} s: {file_bytes / wall / 1e9:.3f} GB/s of client bytes, "
            f"{3 * file_bytes / wall / 1e9:.3f} GB/s replicated (host clock); "
            f"B1 launches {launches_file} for the file, {launches['crc_words']} with "
            f"the mix ({sum(len(r) for r in mix)} write_chunk in {len(mix)} rounds, "
            f"{mix_wall:.3f} s); the client's native host CRC of the file alone "
            f"{host_crc_s:.3f} s ({host_crc_s / wall * 100:.1f}% of the wall)")
        log(f"[21] per node (B1 batches, items, items per batch): " + ", ".join(
            f"n{i + 1} {b}, {it}, {it / max(b, 1):.1f}" for i, (b, it) in enumerate(per_node))
            + f"; device-size updates {device_updates}; every byte read back, every "
            f"replica's checksum equal to the native host CRC ({len(want_crc)} chunks) "
            f"and to plain B1 ({len(full)} full chunks), update_ver == commit_ver")
        expect(all(it == device_updates for _, it in per_node),
               f"[21] batched items {per_node} != device-size updates {device_updates}")
        expect(launches["crc_words"] > 0 or dev.type != "cuda",
               "[21] the chain write launched no B1")
        return launches
    finally:
        await sc.close()
        await fabric.stop()


def chain_device_times(dev: torch.device, chunk_bytes: int) -> dict:
    """What one chain hop puts on the card for a 4 MiB payload, each part
    timed alone with CUDA events: B1 on one row (the batch the chain's
    backend launched) and the pinned H2D copy of the payload."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    cw = chunk_bytes // 4
    tables = codec_tables(cw // 128, device=dev)
    host = torch.empty((1, cw), dtype=torch.int32, pin_memory=True)
    host.copy_(torch.randint(-2**31, 2**31, (1, cw), dtype=torch.int32))
    words = host.to(dev)
    b1 = kernel_times(lambda: cc.crc_words_raw(words, tables))
    h2d = kernel_times(lambda: words.copy_(host, non_blocking=True))
    bound = chunk_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[21] alone, CUDA events, median of {REPEATS} (min, max): B1 on (1, {cw}) = "
        f"one 4 MiB row {b1['ms'] * 1e3:.1f} us ({b1['min_ms'] * 1e3:.1f}, "
        f"{b1['max_ms'] * 1e3:.1f}; bound {bound * 1e3:.2f} us by bytes); pinned H2D "
        f"of 4 MiB {h2d['ms'] * 1e3:.1f} us ({h2d['min_ms'] * 1e3:.1f}, "
        f"{h2d['max_ms'] * 1e3:.1f})")
    return {"b1_ms": b1["ms"], "h2d_ms": h2d["ms"]}


# --- phase 22: the EC stripe path end to end ----------------------------------

def ec_target_engine(fabric, chain_id: int):
    """The engine of a one-replica chain's target."""
    t = fabric.routing.chains[chain_id].targets[0]
    return fabric.nodes[t.node_id - 1].targets[t.target_id].engine


async def ec_remove(fabric, lay, inode: int, stripe: int, slot: int) -> None:
    """Remove one shard's chunk through Storage.remove_chunks at its chain's
    head (tests/test_torch_ec_client.py's _remove_shard)."""
    from t3fs_torch.storage.types import RemoveChunksReq

    chain_id = lay.shard_chain(stripe, slot)
    cid = lay.shard_chunk(inode, stripe, slot)
    head = fabric.routing.chains[chain_id].head()
    await fabric.client.call(
        fabric.routing.node_address(head.node_id), "Storage.remove_chunks",
        RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                        begin_index=cid.index, end_index=cid.index + 1))


async def limited(n: int, coros) -> list:
    """Await the coroutines with at most n in flight, results in order."""
    sem = asyncio.Semaphore(n)

    async def one(c):
        async with sem:
            return await c
    return await asyncio.gather(*(one(c) for c in coros))


def ec_ok(results) -> bool:
    return all(r.status.code == 0 for r in results)


async def ec_read_all(ec, lay, inode: int, stripes, stripe_len: int,
                      data: np.ndarray, want_crc: np.ndarray, tag: str) -> None:
    """read_stripe_with_crcs of `stripes`, EC_INFLIGHT in flight: every byte
    against the written data, every returned CRC against plain B1."""
    outs = await limited(EC_INFLIGHT, (ec.read_stripe_with_crcs(
        lay, inode, s, stripe_len) for s in stripes))
    for s, (got, crcs) in zip(stripes, outs):
        expect(got == data[s].tobytes()[:stripe_len],
               f"[22] {tag}: stripe {s} read back differs")
        expect(crcs == [int(c) for c in want_crc[s]],
               f"[22] {tag}: stripe {s} CRCs {crcs} != plain B1 {want_crc[s].tolist()}")


def ec_check_repaired(fabric, lay, inode: int, lost: dict, data: np.ndarray,
                      want_crc: np.ndarray, tag: str) -> None:
    """Every repaired chunk committed, its stored bytes equal to the written
    chunk and its ChunkMeta.checksum to the native host CRC of them; a data
    chunk's checksum also equal to plain B1 of the written chunk, an RS
    parity chunk's bytes to the plain encode (RSCode.encode_ref) of data[s]."""
    from t3fs_torch.ops import codec
    from t3fs_torch.ops.rs import default_rs

    k = lay.k
    rs = default_rs(k, lay.m)
    for s, slots in lost.items():
        parity = None
        for slot in slots:
            engine = ec_target_engine(fabric, lay.shard_chain(s, slot))
            cid = lay.shard_chunk(inode, s, slot)
            meta = engine.get_meta(cid)
            if slot < k:
                want = data[s, slot].tobytes()
            else:
                expect(not lay.local_scheme and slot < k + lay.m,
                       f"[22] {tag}: slot {slot} is not an RS parity slot")
                if parity is None:
                    parity = rs.encode_ref(data[s])
                want = parity[slot - k].tobytes()
            crc = codec.crc32c(want)
            expect(meta is not None and meta.checksum == crc
                   and meta.update_ver == meta.commit_ver
                   and (slot >= k or crc == int(want_crc[s, slot])),
                   f"[22] {tag}: repaired stripe {s} slot {slot}: {meta} "
                   f"!= native {crc:#x}")
            expect(engine.read(cid) == want,
                   f"[22] {tag}: repaired stripe {s} slot {slot}: stored bytes differ")


async def phase_ec_stripes(dev: torch.device, chunk_bytes: int = SHARD_BYTES,
                           stripes: int = EC_STRIPES,
                           small: int = EC_SMALL_STRIPES,
                           loss_reads: int = EC_NODE_LOSS_READS) -> dict:
    """The EC stripe path through the port's entry points: StorageFabric(5
    nodes, 10 one-replica chains, two a node), a CudaChecksumBackend per
    node on `dev`, the native engine and io_uring reads (the defaults),
    StorageClient, ECStorageClient over TorchECCodec(device=dev).  RS(8+2)
    at `chunk_bytes`: `stripes` seeded stripes written EC_INFLIGHT in
    flight, read back healthy; every chunk of one chain removed and every
    stripe read degraded; RepairDriver(concurrency=8) over those losses on
    the sub-shard path, every stripe read back; then `small` stripes each
    of pm-msr (8+2: write, one-loss repair_stripe, two-loss read), RS(6+3)
    (write, degraded read, repair) and lrc-xor (6+2, groups of 4: write, a
    local-group repair), one RS(8+2) stripe ending mid-chunk (its trimmed
    tail on the host CRC); last one node's server stops (two chains, the
    m = 2 limit) and `loss_reads` stripes read degraded.  Every byte and
    CRC against the data and plain B1; returns the phase's launches."""
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient, RepairIOStats
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.client.repair import RepairDriver, RepairJob
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.ops import codec as host
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.storage.codec_backend import (
        DEFAULT_MIN_DEVICE_BYTES, CudaChecksumBackend)
    from t3fs_torch.storage.native_engine import NativeChunkEngine
    from t3fs_torch.testing.fabric import StorageFabric

    cs = chunk_bytes
    rng = np.random.default_rng(SEED + 22)
    fabric = StorageFabric(num_nodes=5, replicas=1, num_chains=10,
                           checksum_backend=lambda: CudaChecksumBackend(device=dev))
    await fabric.start()
    sc = StorageClient(lambda: fabric.routing, client=fabric.client)
    codec = TorchECCodec(device=dev)
    ec = ECStorageClient(sc, codec=codec)
    try:
        engines = [(n.node_id, tid, type(t.engine).__name__)
                   for n in fabric.nodes for tid, t in sorted(n.targets.items())]
        log(f"[22] targets (node, target, engine): {engines}; io_uring worker "
            f"on nodes {[n.node_id for n in fabric.nodes if n.aio is not None]}")
        expect(all(isinstance(t.engine, NativeChunkEngine)
                   for n in fabric.nodes for t in n.targets.values()),
               f"[22] a target is not on the native engine: {engines}")
        lay = ECLayout.create(k=K, m=M, chunk_size=cs, chains=fabric.chain_ids)
        driver = RepairDriver(ec, concurrency=8)
        # the builds (tables, first launches) off the timed path
        for node in fabric.nodes:
            await asyncio.to_thread(node.codec.warmup,
                                    [n for n in (cs,) if n >= DEFAULT_MIN_DEVICE_BYTES])
        codec.warmup_decode([(tuple(range(1, K + 1)), (0,)),
                             ((0, 2, 3, 4, 5, 7, 8, 9), (1, 6))], cs, K, M)
        await driver.warmup([lay])
        data = rng.integers(0, 256, (stripes, K, cs), dtype=np.uint8)
        want_crc = plain_shard_crcs(data, dev)
        total = {}
        inode = 1

        cc.reset_launches()
        t0 = time.perf_counter()
        res = await limited(EC_INFLIGHT, (ec.write_stripe(lay, inode, s, data[s].tobytes())
                                          for s in range(stripes)))
        w_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        w_launches = dict(cc.launches)
        expect(all(ec_ok(r) for r in res), "[22] a stripe write failed")
        w_flush = (codec.flushes, codec.batched_items)

        cc.reset_launches()
        t0 = time.perf_counter()
        await ec_read_all(ec, lay, inode, range(stripes), K * cs, data, want_crc,
                          "healthy read")
        h_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        dead = fabric.chain_ids[0]
        losses = {s: tuple(sl for sl in range(K + M) if lay.shard_chain(s, sl) == dead)
                  for s in range(stripes)}
        for s, slots in losses.items():
            for sl in slots:
                await ec_remove(fabric, lay, inode, s, sl)
        n_lost = sum(map(len, losses.values()))
        cc.reset_launches()
        t0 = time.perf_counter()
        await ec_read_all(ec, lay, inode, range(stripes), K * cs, data, want_crc,
                          f"degraded read, chain {dead} lost")
        d_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        d_launches = dict(cc.launches)

        cc.reset_launches()
        t0 = time.perf_counter()
        report = await driver.run([RepairJob(
            layout=lay, inode=inode, stripe_len_of={s: K * cs for s in range(stripes)},
            losses=losses)])
        r_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        r_launches = dict(cc.launches)
        expect(not report.failed and report.repaired_shards == n_lost,
               f"[22] repair: {report}")
        expect(report.reduced_shards == n_lost and report.fallback_shards == 0,
               f"[22] repair took the full-k fallback: {report}")
        ec_check_repaired(fabric, lay, inode, losses, data, want_crc, "RepairDriver")
        cc.reset_launches()
        await ec_read_all(ec, lay, inode, range(stripes), K * cs, data, want_crc,
                          "read after repair")
        add_launches(total, cc.launches)

        data_bytes = stripes * K * cs
        log(f"[22] RS({K}+{M}) at {cs >> 10} KiB chunks, {stripes} stripes "
            f"({data_bytes >> 20} MiB of data, {stripes * (K + M) * cs >> 20} MiB "
            f"stored), {EC_INFLIGHT} calls in flight (host clock): write "
            f"{w_wall:.3f} s, {data_bytes / w_wall / 1e9:.3f} GB/s of data; healthy "
            f"read {h_wall:.3f} s, {data_bytes / h_wall / 1e9:.3f} GB/s; degraded "
            f"read (chain {dead} lost, {n_lost} shards) {d_wall:.3f} s, "
            f"{data_bytes / d_wall / 1e9:.3f} GB/s of data; RepairDriver "
            f"(concurrency 8, subshard) {r_wall:.3f} s: {report.bytes_repaired / r_wall / 1e9:.3f} "
            f"GB/s rebuilt, {report.bytes_read / r_wall / 1e9:.3f} GB/s of helper "
            f"bytes ({report.bytes_read / 2**20:.1f} MiB read for "
            f"{report.bytes_repaired / 2**20:.1f} MiB, {report.sub_reads} sub-reads, "
            f"reduced {report.reduced_shards}, fallback {report.fallback_shards}, "
            f"chain reads {report.min_chain_reads}..{report.max_chain_reads})")
        log(f"[22] launches: write {w_launches}; degraded read {d_launches}; "
            f"repair {r_launches}; codec flushes and items after the write "
            f"{w_flush[0]}, {w_flush[1]} ({w_flush[1] / max(w_flush[0], 1):.2f} a flush)")

        # pm-msr (8+2): write, one-loss projection repair, two-loss read
        small_data = rng.integers(0, 256, (small, K, cs), dtype=np.uint8)
        small_crc = plain_shard_crcs(small_data, dev)
        cc.reset_launches()
        t0 = time.perf_counter()
        msr = ECLayout.create(k=K, m=M, chunk_size=cs, chains=fabric.chain_ids,
                              local_scheme="pm-msr")
        res = await limited(EC_INFLIGHT, (ec.write_stripe(msr, 2, s, small_data[s].tobytes())
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), "[22] a pm-msr write failed")
        stats = RepairIOStats()
        for s in range(small):
            await ec_remove(fabric, msr, 2, s, 3)
        res = await limited(EC_INFLIGHT, (ec.repair_stripe(msr, 2, s, (3,), K * cs, stats=stats)
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res) and stats.reduced_shards == small
               and stats.fallback_shards == 0, f"[22] pm-msr repair: {stats}")
        ec_check_repaired(fabric, msr, 2, {s: (3,) for s in range(small)},
                          small_data, small_crc, "pm-msr repair")
        for s in range(small):
            for sl in (1, 8):
                await ec_remove(fabric, msr, 2, s, sl)
        await ec_read_all(ec, msr, 2, range(small), K * cs, small_data, small_crc,
                          "pm-msr two-loss read")
        msr_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        # RS(6+3): write (B5 + B6), degraded read, repair
        d63 = rng.integers(0, 256, (small, K63, cs), dtype=np.uint8)
        c63 = plain_shard_crcs(d63, dev)
        cc.reset_launches()
        t0 = time.perf_counter()
        rs63 = ECLayout.create(k=K63, m=M63, chunk_size=cs, chains=fabric.chain_ids)
        res = await limited(EC_INFLIGHT, (ec.write_stripe(rs63, 3, s, d63[s].tobytes())
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), "[22] an RS(6+3) write failed")
        for s in range(small):
            for sl in (0, 4, 7):
                await ec_remove(fabric, rs63, 3, s, sl)
        await ec_read_all(ec, rs63, 3, range(small), K63 * cs, d63, c63,
                          "RS(6+3) read, 3 lost")
        stats63 = RepairIOStats()
        res = await limited(EC_INFLIGHT, (ec.repair_stripe(rs63, 3, s, (0, 4, 7), K63 * cs,
                                                           stats=stats63)
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), f"[22] RS(6+3) repair: {stats63}")
        ec_check_repaired(fabric, rs63, 3, {s: (0, 4, 7) for s in range(small)},
                          d63, c63, "RS(6+3) repair")
        rs63_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        # lrc-xor (6+2, groups of 4): write, then a local-group repair
        lrc = ECLayout.create(k=6, m=2, chunk_size=cs, chains=fabric.chain_ids,
                              local_scheme="lrc-xor", local_group_size=4)
        dl = rng.integers(0, 256, (small, 6, cs), dtype=np.uint8)
        cl = plain_shard_crcs(dl, dev)
        cc.reset_launches()
        t0 = time.perf_counter()
        res = await limited(EC_INFLIGHT, (ec.write_stripe(lrc, 4, s, dl[s].tobytes())
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res), "[22] an lrc-xor write failed")
        for s in range(small):
            await ec_remove(fabric, lrc, 4, s, 2)
        statsl = RepairIOStats()
        res = await limited(EC_INFLIGHT, (ec.repair_stripe(lrc, 4, s, (2,), 6 * cs,
                                                           stats=statsl)
                                          for s in range(small)))
        expect(all(ec_ok(r) for r in res) and statsl.reduced_shards == small
               and statsl.bytes_read == small * 4 * cs,
               f"[22] lrc-xor group repair: {statsl}")
        ec_check_repaired(fabric, lrc, 4, {s: (2,) for s in range(small)}, dl, cl,
                          "lrc-xor repair")
        await ec_read_all(ec, lrc, 4, range(small), 6 * cs, dl, cl, "lrc-xor read")
        lrc_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)

        # one RS(8+2) stripe ending mid-chunk: the trimmed tail's CRC is the
        # host's (stored), a rebuilt tail reports none
        tail_len = 5 * cs + cs // 2 + 123
        dt = rng.integers(0, 256, (1, K, cs), dtype=np.uint8)
        dt.reshape(-1)[tail_len:] = 0
        ct = plain_shard_crcs(dt, dev)
        tail = dt[0].tobytes()[:tail_len]
        ct[0, 5] = host.crc32c(tail[5 * cs:])
        cc.reset_launches()
        res = await ec.write_stripe(lay, 5, 0, tail)
        expect(ec_ok(res), "[22] the mid-chunk stripe write failed")
        meta = ec_target_engine(fabric, lay.shard_chain(0, 5)).get_meta(
            lay.shard_chunk(5, 0, 5))
        expect(meta.length == tail_len - 5 * cs and meta.checksum == int(ct[0, 5]),
               f"[22] the trimmed tail's stored CRC {meta}")
        got, crcs = await ec.read_stripe_with_crcs(lay, 5, 0, tail_len)
        # the tail reports its stored CRC when read, none when the first-k
        # read decoded it; the zero holes report none
        expect(got == tail and crcs[:5] == [int(c) for c in ct[0, :5]]
               and crcs[5] in (int(ct[0, 5]), None) and crcs[6:] == [None, None],
               f"[22] mid-chunk read {crcs}")
        await ec_remove(fabric, lay, 5, 0, 5)
        got, crcs = await ec.read_stripe_with_crcs(lay, 5, 0, tail_len)
        expect(got == tail and crcs[5] is None, f"[22] mid-chunk degraded read {crcs}")
        res = await ec.repair_stripe(lay, 5, 0, (5,), tail_len)
        meta = ec_target_engine(fabric, lay.shard_chain(0, 5)).get_meta(
            lay.shard_chunk(5, 0, 5))
        expect(ec_ok(res) and meta.checksum == int(ct[0, 5])
               and meta.update_ver == meta.commit_ver,
               f"[22] the repaired tail's stored CRC {meta}")
        add_launches(total, cc.launches)

        # one node's server stops: its two chains (the m = 2 limit) lost
        victim = fabric.nodes[1]
        lost_slots = tuple(sl for sl in range(K + M) if fabric.routing.chains[
            lay.shard_chain(0, sl)].targets[0].node_id == victim.node_id)
        await fabric.servers[1].stop()
        cc.reset_launches()
        t0 = time.perf_counter()
        await ec_read_all(ec, lay, inode, range(loss_reads), K * cs, data, want_crc,
                          f"node {victim.node_id} down, slots {lost_slots} lost")
        n_wall = time.perf_counter() - t0
        add_launches(total, cc.launches)
        nbytes = loss_reads * K * cs
        log(f"[22] pm-msr ({small} stripes: write, repair of slot 3, two-loss read) "
            f"{msr_wall:.3f} s, repair {stats}; RS(6+3) ({small}: write, read "
            f"losing (0, 4, 7), repair) {rs63_wall:.3f} s, {stats63}; lrc-xor "
            f"(6+2, groups {lrc.local_groups()}: write, group repair of slot 2) "
            f"{lrc_wall:.3f} s, {statsl}; one stripe of {tail_len} B, its "
            f"tail's CRC on the host; node {victim.node_id} down (slots "
            f"{lost_slots}): {loss_reads} degraded reads {n_wall:.3f} s, "
            f"{nbytes / n_wall / 1e9:.3f} GB/s of data")
        per_node = [(n.node_id, n.codec.batches, n.codec.batched_items,
                     n.aio.completed if n.aio is not None else "no io_uring worker")
                    for n in fabric.nodes]
        log(f"[22] per node (B1 batches, items, io_uring reads completed): "
            + ", ".join(f"n{i} {b}, {it}, {a}" for i, b, it, a in per_node))
        log(f"[22] codec: {codec.flushes} flushes, {codec.batched_items} items "
            f"({codec.batched_items / max(codec.flushes, 1):.2f} a flush), "
            f"{codec.batches} key groups, codec_counts={codec.codec_counts}; "
            f"phase launches {total}")
        expect_routes(codec, ("cuda-encode-words", "cuda-decode-words",
                              "cuda-repair-words", "cuda-encode-bytes",
                              "cuda-decode-bytes", "cuda-msr-encode",
                              "cuda-msr-repair", "cuda-msr-decode"))
        if dev.type == "cuda":
            for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words",
                         "repair_words", "rs_bitmatmul", "crc_bytes"):
                expect(total.get(name, 0) > 0, f"[22] the EC path launched no {name}")
        return total
    finally:
        await ec.close()
        await sc.close()
        await fabric.stop()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a GPU", file=sys.stderr)
        return 1
    from t3fs_torch.benchmarks.devbench import card_line
    from t3fs_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"[0] {card}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} (x{torch.cuda.device_count()})")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[0] kernel build: {time.perf_counter() - t0:.1f} s")
    from t3fs_torch.ops.codec import host_impl
    from t3fs_torch.storage.aio import AioReadWorker
    t0 = time.perf_counter()
    expect(host_impl() == "native", "the native host library (csrc/chunk_engine.cpp, "
           "csrc/aio_reader.cpp) did not build or its CRC failed the self-check")
    log(f"[0] native host library: chunk engine, host CRC and io_uring reader "
        f"(chunk_engine.cpp, aio_reader.cpp, g++): {time.perf_counter() - t0:.1f} s; "
        f"io_uring available: {AioReadWorker.available()}")
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"[0] nvcc {name}: {line.strip()}")

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    e_crc = phase_crc(dev, g, CHUNK_BYTES // 4, CHUNKS, 4096)
    e_rs, e_step_crc = phase_stripe(dev, g, SHARD_BYTES // 4, STRIPES)
    main_runs = [asyncio.run(phase_storage(dev, storage_sizes(CHUNK_BYTES))),
                 asyncio.run(phase_ec(dev, SHARD_BYTES, 24))]
    times = phase_times(dev, g)
    read_errs = phase_read_kernels(dev, g)
    full = raid6_stripes(dev, g, LOST_CHUNKS)
    crcs = plain_shard_crcs(full, dev)
    main_runs.append(asyncio.run(phase_degraded(dev, full, crcs)))
    main_runs.append(asyncio.run(phase_repair(dev, full, crcs)))
    del full
    main_runs.append(asyncio.run(phase_nonraid6(dev, g)))
    read_times = phase_read_times(dev, g)
    e_bytes = phase_crc_bytes(dev, g)
    main_runs.append(asyncio.run(phase_byte_routes(dev)))
    main_runs.append(asyncio.run(phase_msr(dev)))
    big_errs = phase_big_kernels(dev, g)
    main_runs.append(asyncio.run(phase_big_codes(dev)))
    byte_times = phase_byte_times(dev, g, times["crc_words"])
    e_copy, copy_times, bench_launches = phase_bench(dev, g)
    main_runs.append(bench_launches)
    phase_sort()
    main_runs.append(phase_mesh(dev))
    main_runs.append(phase_entry(dev))
    for pipeline in ("off", "overlap"):
        main_runs.append(asyncio.run(
            phase_chain(dev, pipeline, CHAIN_FILE_BYTES, CHUNK_BYTES)))
    chain_device_times(dev, CHUNK_BYTES)
    main_runs.append(asyncio.run(phase_ec_stripes(dev)))

    from t3fs_torch.benchmarks.devbench import launches as _bench_names
    from t3fs_torch.ops.cuda_codec import launches as _codec_names

    # phases 7, 8, 12 and 13 check every CRC the fused steps returned
    # against plain B1 or B6 and every rebuilt byte, so a mismatch there
    # already failed
    meta = {
        "crc_words": ("t3fs_torch/csrc/crc_words.cu",
                      "t3fs/ops/pallas_codec.py:310", max(e_crc, e_step_crc),
                      times["crc_words"]),
        "rs_raid6_words": ("t3fs_torch/csrc/rs_raid6_words.cu",
                           "t3fs/ops/pallas_codec.py:261", e_rs,
                           times["rs_raid6_words"]),
        "rs_reconstruct_words": ("t3fs_torch/csrc/rs_reconstruct_words.cu",
                                 "t3fs/ops/pallas_codec.py:502",
                                 read_errs["rs_reconstruct_words"],
                                 read_times["rs_reconstruct_words want=(0, 9)"]),
        "repair_words": ("t3fs_torch/csrc/repair_words.cu",
                         "t3fs/ops/pallas_codec.py:587",
                         max(read_errs["repair_words"], big_errs["repair_words"]),
                         read_times["repair_words slot 3, XOR fold"]),
        "rs_bitmatmul": ("t3fs_torch/csrc/rs_bitmatmul.cu", "t3fs/ops/pallas_codec.py:68",
                         max(read_errs["rs_bitmatmul"], big_errs["rs_bitmatmul"]),
                         read_times[f"rs_bitmatmul RS(6+3) decode want={LOST63}"]),
        "crc_bytes": ("t3fs_torch/csrc/crc_bytes.cu",
                      "t3fs/ops/pallas_codec.py:116", e_bytes,
                      byte_times["crc_bytes 64 x 4 MiB"]),
        "copy3d": ("t3fs_torch/csrc/copy3d.cu", "benchmarks/devbench.py:91", e_copy,
                   copy_times),
    }
    kernels = []
    for name in [*_codec_names, *_bench_names]:
        source, replaces, err, t = meta[name]
        launched = sum(run.get(name, 0) for run in main_runs)
        expect(launched > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t.get("library_ms"),
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
