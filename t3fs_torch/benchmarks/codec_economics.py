"""Device-offload economics: does the CRC batching seam scale to line rate
on a co-located card?

What is measurable, and independent of the card, is the BATCHING BEHAVIOR
of the seam: how many payload bytes the micro-batcher accumulates per
kernel launch under real CRAQ write load (the batch window closes on the
event loop's schedule, not the device's).  Combined with the card's kernel
rate at that batch, its launch cost and the host-to-device copy rate, that
bounds what a co-located card sustains:

    t(batch) = launch_overhead + bytes/pcie_bw + bytes/kernel_rate
    sustained = bytes / t(batch)

    python -m t3fs_torch.benchmarks.codec_economics --json

The port of benchmarks/codec_economics.py, with the same arguments and JSON
keys.  The reference's model constants were a TPU's (its kernel rate and
dispatch cost); none carries over.  This bench measures them on the card in
the same run, at each measured batch's shape: B1's (crc_words.cu) GB/s of
payload bytes on the device alone (CUDA events around replays of calls
captured in a CUDA graph, so no host issue cost is in it), the host's cost
of one B1 launch, kept apart as the model's launch term, and the card's
pinned host-to-device copy rate, which joins the reference's interconnect
rows as one more.  The three model functions take the kernel
rate and launch cost as arguments and are otherwise the reference's.  The
card is the default; without a GPU the bench raises.  --cpu runs the
batching seam on B1's plain version on the CPU and times that version as
the "kernel" (no copy row): a check of the arithmetic, not of the card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import torch

from t3fs_torch import resolve_device

LINE_RATE_GBPS = 50.0          # 2 x 200 Gbps per storage node
INTERCONNECTS = {              # host->device copy bandwidth, GB/s
    "pcie3x16": 12.0,
    "pcie4x16": 24.0,
    "co-packaged (CI/offload engine)": 100.0,
}
# the measured row: the card's own pinned host-to-device copy rate
MEASURED_H2D = "this card's host-to-device copy (measured)"
# bytes of the copy-rate probe
H2D_PROBE_BYTES = 64 << 20
# host-timed back-to-back B1 calls for the launch cost
LAUNCH_CALLS = 200


def sustained_gbps(batch_bytes: float, pcie_gbps: float, kernel_gbps: float,
                   launch_s: float) -> float:
    """SERIAL (store-and-forward) bound: copy, then compute."""
    if batch_bytes <= 0:
        return 0.0
    t = (launch_s + batch_bytes / (pcie_gbps * 1e9)
         + batch_bytes / (kernel_gbps * 1e9))
    return batch_bytes / t / 1e9


def pipelined_gbps(batch_bytes: float, pcie_gbps: float, kernel_gbps: float,
                   launch_s: float) -> float:
    """DOUBLE-BUFFERED bound: H2D of batch n+1 overlaps compute of batch
    n, so throughput approaches min(copy, kernel) as batches amortize the
    launch overhead.  This is what the seam must implement to scale."""
    if batch_bytes <= 0:
        return 0.0
    per_batch = max(batch_bytes / (pcie_gbps * 1e9),
                    launch_s + batch_bytes / (kernel_gbps * 1e9))
    return batch_bytes / per_batch / 1e9


def batch_for_line_rate(pcie_gbps: float, kernel_gbps: float,
                        launch_s: float) -> float | None:
    """Smallest batch (bytes) that sustains LINE_RATE_GBPS, or None when
    the interconnect itself cannot carry line rate."""
    # 1/sustained = LAUNCH/B + 1/pcie + 1/kernel  -> solve for B
    budget = 1.0 / (LINE_RATE_GBPS * 1e9)
    per_byte = 1.0 / (pcie_gbps * 1e9) + 1.0 / (kernel_gbps * 1e9)
    if per_byte >= budget:
        return None
    return launch_s / (budget - per_byte)


async def measure_batching(chunk_size: int, seconds: float, concurrency: int,
                           checksum_backend="cuda") -> dict:
    """Drive CRAQ writes through the in-process fabric with the batching
    codec (`checksum_backend`: the card, or a CudaChecksumBackend factory on
    the CPU) and read the micro-batcher's counters."""
    from t3fs_torch.benchmarks.storage_bench import parse_args, run_bench
    from t3fs_torch.testing.fabric import StorageFabric
    from t3fs_torch.testing.spies import spied

    args = parse_args(["--mode", "write", "--nodes", "1",
                       "--replicas", "1",
                       "--chunk-size", str(chunk_size),
                       "--num-chunks", "64",
                       "--concurrency", str(concurrency),
                       "--seconds", str(seconds),
                       "--checksum-backend", "cuda"])
    args.checksum_backend = checksum_backend
    with spied(StorageFabric, "start", []) as fabrics:
        res = await run_bench(args)
    codec = fabrics[0].nodes[0].codec
    batches = max(1, codec.batches)
    items = codec.batched_items
    return {
        "write_MB_s": res.get("MB_s"),
        "batches": codec.batches,
        "batched_items": items,
        "items_per_batch": round(items / batches, 2),
        "batch_bytes": round(items / batches * chunk_size),
    }


def _device_ms(fn, device: torch.device) -> float:
    """Time of one call of fn, ms: on the card the device's alone (the
    median of 5 replays of 20 calls captured in a CUDA graph, CUDA events),
    the host clock on the CPU."""
    if device.type == "cuda":
        from t3fs_torch.benchmarks.devbench import graph_samples
        return graph_samples(fn)[2]
    fn()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    return (time.perf_counter() - t0) / 5 * 1e3


def measure_card(chunk_size: int, items_per_batch: float,
                 device: str | torch.device = "cuda") -> dict:
    """The model's constants at one measured batch: B1 (the function the
    checksum backend launches for a chunk_size payload's bucket) on
    max(1, round(items_per_batch)) rows; GB/s of payload bytes on the
    device alone, and the host's cost of one call, averaged over
    LAUNCH_CALLS back-to-back calls (3 on the CPU, where a call is the whole
    plain computation) on inputs already on the device."""
    from t3fs_torch.ops.cuda_codec import make_crc32c_words_raw
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend

    dev = resolve_device(device)
    rows = max(1, round(items_per_batch))
    chunk_words = CudaChecksumBackend._bucket_words(chunk_size)
    fn = make_crc32c_words_raw(chunk_words, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    words = torch.randint(-2**31, 2**31, (rows, chunk_words), generator=g,
                          dtype=torch.int32, device=dev)
    ms = _device_ms(lambda: fn(words), dev)
    fn(words)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    calls = LAUNCH_CALLS if dev.type == "cuda" else 3
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(words)
    launch_s = (time.perf_counter() - t0) / calls
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"rows": rows, "chunk_words": chunk_words,
            "kernel_ms": ms, "kernel_GBps": rows * chunk_size / ms / 1e6,
            "launch_us": launch_s * 1e6}


def measure_h2d(nbytes: int = H2D_PROBE_BYTES) -> float:
    """GB/s of one pinned host-to-device copy of nbytes, CUDA events (the
    median of 5 samples of 20 copies)."""
    from t3fs_torch.benchmarks.devbench import median_ms

    dev = resolve_device("cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = median_ms(lambda: dst.copy_(host, non_blocking=True))
    return nbytes / ms / 1e6


def model(measured: dict, card: dict, h2d_gbps: float | None) -> dict:
    """The reference's model table, per chunk size and interconnect, at each
    measured batch with the card's rate and launch cost from `card`."""
    out = {}
    links = dict(INTERCONNECTS)
    if h2d_gbps is not None:
        links[MEASURED_H2D] = h2d_gbps
    for key, m in measured.items():
        kernel_gbps, launch_s = card[key]["kernel_GBps"], card[key]["launch_us"] / 1e6
        per_if = {}
        for name, bw in links.items():
            pipelined = pipelined_gbps(m["batch_bytes"], bw, kernel_gbps, launch_s)
            per_if[name] = {
                "serial_GBps_at_measured_batch": round(
                    sustained_gbps(m["batch_bytes"], bw, kernel_gbps, launch_s), 2),
                "pipelined_GBps_at_measured_batch": round(pipelined, 2),
                "pipelined_vs_line_rate": round(pipelined / LINE_RATE_GBPS, 3),
            }
            need = batch_for_line_rate(bw, kernel_gbps, launch_s)
            per_if[name]["serial_min_batch_for_line_rate"] = (
                round(need) if need is not None else "unreachable")
        out[key] = per_if
    return out


async def main_async(args) -> dict:
    device = torch.device("cpu" if args.cpu else "cuda")
    if args.cpu:
        from t3fs_torch.storage.codec_backend import CudaChecksumBackend

        def backend():
            return CudaChecksumBackend(device="cpu")
    else:
        backend = "cuda"
    measured = {}
    for cs in args.chunk_sizes:
        measured[f"chunk_{cs}"] = await measure_batching(
            cs, args.seconds, args.concurrency, backend)
    card = {f"chunk_{cs}": measure_card(
                cs, measured[f"chunk_{cs}"]["items_per_batch"], device)
            for cs in args.chunk_sizes}
    h2d = None if args.cpu else measure_h2d()
    return report(measured, card, h2d, device)


def report(measured: dict, card: dict, h2d_gbps: float | None,
           device: torch.device) -> dict:
    """The result record: the reference's keys, with the kernel rate and
    launch cost of each measured batch (the card's, or the plain version's
    under --cpu) in place of its constants."""
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu (plain versions)")
    return {"device": name, "line_rate_GBps": LINE_RATE_GBPS,
            "kernel_GBps": {k: v["kernel_GBps"] for k, v in card.items()},
            "launch_overhead_us": {k: v["launch_us"] for k, v in card.items()},
            "h2d_GBps": h2d_gbps,
            "card": card, "measured": measured,
            "model": model(measured, card, h2d_gbps)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="codec_economics")
    ap.add_argument("--chunk-sizes", type=int, nargs="+",
                    default=[65536, 1 << 20])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="the seam on B1's plain version on the CPU")
    ap.add_argument("--device", action="store_true",
                    help="the card (the default)")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card unless asked for the CPU: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    res = asyncio.run(main_async(args))
    if not args.cpu:
        from t3fs_torch.benchmarks.devbench import card_line
        res["card_line"] = card_line()
    if args.json:
        print(json.dumps(res, indent=1))
    else:
        for k, v in res.items():
            print(k, json.dumps(v, indent=1) if isinstance(v, dict) else v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
