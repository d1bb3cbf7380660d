#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's write path on one GPU and check every kernel.

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
  6  the kernels line, the card line, then the ok line last

Launch counts: the counters are set to 0 just before each main-path run
(phases 3 and 4) and read just after; launches made to compare a kernel
with its plain version (phases 1, 2, 5) are not counted.
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


def phase_times(dev: torch.device, g: torch.Generator) -> dict:
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.tables import codec_tables

    out = {}
    cw = CHUNK_BYTES // 4
    tcrc = codec_tables(cw // 128, device=dev)
    words = rand_words(g, dev, CHUNKS, cw)
    nbytes = words.numel() * 4
    out["crc_words"] = {
        "ms": time_ms(lambda: cc.crc_words_raw(words, tcrc), 20),
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
        "ms": time_ms(lambda: cc.rs_raid6_words(data, trs), 20),
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
        "ms": time_ms(lambda: step(data), 20),
        "plain_ms": time_ms(plain_step, 2, 1),
        "bound_ms": rs_bytes / HBM_BYTES_PER_S * 1e3,
        "shape": out["rs_raid6_words"]["shape"],
    }
    for name, t in out.items():
        log(f"[5] {name} {t['shape']}: {t['ms'] * 1e3:.1f} us "
            f"(bound {t['bound_ms'] * 1e3:.1f} us by bytes at 3.35 TB/s, "
            f"{t['bound_ms'] / t['ms'] * 100:.1f}% of it); plain "
            f"{t['plain_ms'] * 1e3:.1f} us; library call: none")
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
    l_storage = asyncio.run(phase_storage(dev, storage_sizes(CHUNK_BYTES)))
    l_ec = asyncio.run(phase_ec(dev, SHARD_BYTES, 24))
    times = phase_times(dev, g)

    from t3fs_torch.ops.cuda_codec import launches as _names

    kernels = []
    meta = {
        "crc_words": ("t3fs_torch/csrc/crc_words.cu",
                      "t3fs/ops/pallas_codec.py:310", max(e_crc, e_step_crc)),
        "rs_raid6_words": ("t3fs_torch/csrc/rs_raid6_words.cu",
                           "t3fs/ops/pallas_codec.py:261", e_rs),
    }
    for name in _names:
        source, replaces, err = meta[name]
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": l_storage[name] + l_ec[name],
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
