"""Device key sort: the twin of t3fs/ops/device_sort.py, the per-partition
key sort of the GraySort-analog.

Records carry 10-byte big-endian keys (gensort layout); a key splits into
three lexicographic columns of 4, 4 and 2 bytes.  The device sorts the key
columns and returns the gather permutation; the host applies it to the
100-byte rows.  `lexsort_rows` (numpy) is the oracle.

The reference sorts the column tuple with one `jax.lax.sort(num_keys=3,
is_stable=True)`, an XLA sort.  torch has no multi-key sort, so the twin
runs two stable `torch.sort`s (CUB's radix sort on the card), least
significant first, on int64 copies of the columns:

  1. the 48-bit composite (k1 << 16) | k2, exact since k2 < 2^16;
  2. k0, gathered through the first permutation.

Stability makes the pair one lexicographic sort that keeps tied rows in
row order.  The shifts run on int64: the CPU build of torch has no uint32
shifts.

The reference pads each call to a power-of-two bucket of 0xFFFFFFFF
sentinels only so that XLA compiles once per bucket, and drops the
permutation's entries >= n after the sort.  torch compiles nothing per
shape, so the twin does not pad; its permutation equals the reference's
unpadded one, the tie of a real all-0xFF key with the sentinels included.
"""

from __future__ import annotations

import numpy as np
import torch

from t3fs_torch import resolve_device

KEY_LEN = 10
REC_LEN = 100


def key_columns(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n, REC_LEN) uint8 rows -> three uint32 lexicographic key columns."""
    assert rows.dtype == np.uint8 and rows.ndim == 2
    k0 = rows[:, 0:4].copy().view(">u4").ravel().astype(np.uint32)
    k1 = rows[:, 4:8].copy().view(">u4").ravel().astype(np.uint32)
    k2 = rows[:, 8:10].copy().view(">u2").ravel().astype(np.uint32)
    return k0, k1, k2


def lexsort_rows(rows: np.ndarray) -> np.ndarray:
    """Oracle/CPU backend: permutation sorting rows by their 10-byte key."""
    k0, k1, k2 = key_columns(rows)
    return np.lexsort((k2, k1, k0))


def host_columns(rows: np.ndarray) -> list[np.ndarray]:
    """The three key columns as int64 host arrays, ready to copy."""
    return [c.astype(np.int64) for c in key_columns(rows)]


def sort_columns(k0: torch.Tensor, k1: torch.Tensor,
                 k2: torch.Tensor) -> torch.Tensor:
    """Three (n,) int64 key columns -> (n,) int32 stable lexicographic
    permutation, on their device."""
    _, p1 = torch.sort((k1 << 16) | k2, stable=True)
    _, p2 = torch.sort(k0[p1], stable=True)
    return p1[p2].to(torch.int32)


def make_device_sorter(device: str | torch.device = "cuda"):
    """Returns sort_perm(rows: (n, REC_LEN) uint8 np.ndarray) -> (n,) int32
    permutation (an empty int64 array at n = 0, as the reference), sorted
    on `device`."""
    dev = resolve_device(device)

    def sort_perm(rows: np.ndarray) -> np.ndarray:
        if len(rows) == 0:
            return np.empty(0, dtype=np.int64)
        cols = [torch.from_numpy(c).to(dev) for c in host_columns(rows)]
        return sort_columns(*cols).cpu().numpy()

    return sort_perm
