"""The device key sort on the GPU: the sort stage of benchmarks/sort_bench.py
(`--sort-backend device`) on gensort rows held in memory.

    python3 -m t3fs_torch.benchmarks.sort_bench [--records N | --quick]

The reference runs the GraySort-analog's shuffle through StorageClient,
which the port does not have yet, so this bench sorts one reduce
partition's rows (2^24 records, 1.68 GB, by default; 2^22 with --quick),
made as the reference makes worker 0's input: default_rng(seed).integers(0,
256, (n, 100), uint8), seed 2026.  It reports, on the card:

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
printed with the card.  Without a GPU it raises: it never measures the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.benchmarks.devbench import card_line, median_ms
from t3fs_torch.ops.device_sort import (
    KEY_LEN, REC_LEN, host_columns, lexsort_rows, make_device_sorter, sort_columns)

SEED = 2026
RECORDS = 1 << 24
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


def main(argv=None) -> int:
    resolve_device("cuda")
    ap = argparse.ArgumentParser(prog="t3fs_torch.benchmarks.sort_bench")
    ap.add_argument("--records", type=int, default=RECORDS)
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_RECORDS} records")
    args = ap.parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())
