#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's write and read paths on one GPU and check
every kernel.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught into "ok"):
  0  report the card; build the kernels from t3fs_torch/csrc (into the
     ignored t3fs_torch/_build/) and print the build time
  1  B1 (CRC words) against its plain PyTorch version: random segments,
     4 MiB chunks x 64, the check vector, front-padded odd lengths
  2  B2 (RAID-6 words) and the fused stripe step against plain, at the
     stripe bench's shape: RS(8+2), 1 MiB shards, 12 stripes
  3  storage write path: >= 256 concurrent payload_crc on the "tpu"
     checksum backend (mostly 4 MiB), every CRC checked
  4  EC stripe write path: 24 concurrent TorchECCodec.encode_verified on
     8 x 1 MiB shards, every parity byte and CRC checked
  5  CUDA-event times of B1, B2 and the fused step beside their bounds
     (each the median of REPEATS samples, with their min and max)
  6  B3 (RAID-6 decode words), B4 (repair words) and B5 (byte-plane
     bit-matmul) against their plain versions: B3 on all 55 RS(8+2)
     erasure patterns of one 8 x 1 MiB stripe and at 12 stripes for two
     patterns; B4 on the 10 single-row programs and the LRC all-ones
     program at 96 x 256 KiB sub-shards; B5 decode and encode on RS(6+3)
     (HDFS's RS-6-3-1024k policy) at 12 x 1 MiB shards; one rebuilt stripe
     of each kind against RSCode.decode_ref / eval_program_np
  7  degraded-read path: 24 concurrent TorchECCodec.reconstruct_verified on
     RS(8+2) 1 MiB shards in three erasure patterns (B3 + B1)
  8  repair path: 24 lost 1 MiB chunks of slot 3, each as 4 sub-shards of
     256 KiB over 8 helpers (96 concurrent repair calls, B4 + B1), CRCs
     stitched with crc32c_combine; then LRC local-parity encodes
  9  non-RAID-6 reconstruct: 12 concurrent RS(6+3) reconstruct calls at
     1 MiB shards losing 3 shards (B5)
 10  CUDA-event times of B3, B4, B5 and the fused decode and repair steps
     beside their bounds
 11  the kernels line, the card line, then the ok line last

Launch counts: the counters are set to 0 just before each main-path run
(phases 3, 4, 7, 8 and 9) and read just after; launches made to compare a
kernel with its plain version (phases 1, 2, 5, 6, 10) are not counted.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
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
CHUNKS = 64
SUBSHARDS = 4                  # ec_client.subshard_r(1 MiB): 4 x 256 KiB reads
LOST_CHUNKS = 24               # repair: 24 lost chunks -> 96 sub-shard repairs
LOST_SLOT = 3
READ_PATTERNS = ((2,), (0, 5), (4, 8))
K63, M63 = 6, 3                # HDFS RS-6-3-1024k: RS(6+3), 1 MiB cells
LOST63 = (1, 4, 7)
LRC_GROUP = 3                  # ECLayout.local_group_size
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
    segs = rand_words(g, dev, seg_rows, 128)
    e = max_abs_err(cc.crc_seg_words(segs, t1), cc.crc_seg_words_plain(segs, t1))
    log(f"[1] crc_seg_words ({seg_rows}, 128): max_abs_err={e}")
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
    expect(codec.codec_counts.get("cuda-encode-words", 0) > 0,
           "encode_verified must run the fused word step")
    expect(launches["rs_raid6_words"] > 0 and launches["crc_words"] > 0,
           "EC path must launch B2 and B1")
    return launches


# --- phase 5: times ----------------------------------------------------------

def time_ms(fn, iters: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn) -> dict:
    """ms per call: the median of REPEATS samples of 20 calls, and the
    samples' min and max."""
    samples = sorted(time_ms(fn, 20, warm=2 if i == 0 else 0)
                     for i in range(REPEATS))
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
    del words
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
    e = 0
    for present, want in erasure_patterns():
        dec = decode_tables(present, want, rs, dev)
        e = max(e, max_abs_err(cc.rs_reconstruct_words(one, dec),
                               cc.rs_reconstruct_words_plain(one, dec)))
    log(f"[6] rs_reconstruct_words, all 55 RS(8+2) erasure patterns at (1, {K}, "
        f"{W}): max_abs_err={e}")
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
    expect(codec.codec_counts.get("cuda-decode-words", 0) > 0,
           "reconstruct_verified must run the fused decode step")
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
    expect(codec.codec_counts.get("cuda-repair-words", 0) > 0,
           "repair must run the fused repair step")
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
    expect(codec.codec_counts.get("cuda-bitmatmul", 0) > 0,
           "RS(6+3) reconstruct must run the byte-plane kernel")
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
    for want in ((0, 9), (3,)):
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


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a GPU", file=sys.stderr)
        return 1
    from t3fs_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    log(f"[0] {card}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} (x{torch.cuda.device_count()})")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[0] kernel build: {time.perf_counter() - t0:.1f} s")
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

    from t3fs_torch.ops.cuda_codec import launches as _names

    # phases 7 and 8 check every CRC the fused steps returned against the
    # plain B1 and every rebuilt byte, so a mismatch there already failed
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
                         "t3fs/ops/pallas_codec.py:587", read_errs["repair_words"],
                         read_times["repair_words slot 3, XOR fold"]),
        "rs_bitmatmul": ("t3fs_torch/csrc/rs_bitmatmul.cu",
                         "t3fs/ops/pallas_codec.py:68", read_errs["rs_bitmatmul"],
                         read_times[f"rs_bitmatmul RS(6+3) decode want={LOST63}"]),
    }
    kernels = []
    for name in _names:
        source, replaces, err, t = meta[name]
        launched = sum(run[name] for run in main_runs)
        expect(launched > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
