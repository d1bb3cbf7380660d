"""EC decode microbench on the GPU: twin of the decode microbench of
benchmarks/ec_recovery_bench.py (l.192-299).

    python3 -m t3fs_torch.benchmarks.ec_recovery_bench --decode-ab \
        [--k 8 --m 2 --chunk-size 262144 --decode-batch 4 --json]

Kernel-level decode throughput on synthetic survivors, no cluster IO in the
way: shards 0 and 1 are lost, the first k of shards 2.. are present.  For
the RAID-6 code it times the fused word decode+verify step (B3, then B1 on
survivors and rebuilt shards; `fused_decode_verify_GB_s`) and the word
reconstruct alone (B3; `word_reconstruct_GB_s`); with --decode-ab, or for
any other code, the byte-plane reconstruct (B5; `byteplane_reconstruct_GB_s`),
the word-vs-byte A/B of docs/codec_economics.md.  GB/s counts survivor
bytes in per launch (n*k*L), as the encode bench counts data bytes; each
time is the median of 5 CUDA-event samples of 20 launches.

The reference's cluster phases (write, degraded read and repair over
LocalCluster and ECStorageClient) need the storage layers, which the port
does not have yet, so the closing decode_metric line carries
"degraded_read_MB_s": null.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.benchmarks.devbench import card_line, median_ms
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.rs import default_rs

WANT = (0, 1)                # the lost shards: a double erasure


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
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, default=256 << 10)
    ap.add_argument("--decode-ab", action="store_true",
                    help="also time the byte-plane reconstruct kernel for the "
                         "word-vs-byte A/B")
    ap.add_argument("--decode-batch", type=int, default=4,
                    help="stripes per launch")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The result record: the code, the card and the decode microbench."""
    micro = decode_microbench(args)
    return {"k": args.k, "m": args.m, "chunk_size": args.chunk_size,
            "codec": "cuda", "device": torch.cuda.get_device_name(0),
            "decode_microbench": micro}


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run(args)
        card = card_line()
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
    print(f"card: {card}")
    # one-line scrapable decode metric, printed in both output modes
    print(json.dumps({"decode_metric": {
        f"rs{args.k}+{args.m}_reconstruct_GB_s":
            result["decode_microbench"].get("fused_decode_verify_GB_s"),
        "degraded_read_MB_s": None,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
