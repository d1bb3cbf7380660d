"""Systematic Reed-Solomon RS(k+m) over GF(2^8), bit-matmul formulation.

The port's own copy of t3fs/ops/rs.py (t3fs_torch never imports the JAX
package).  `code_id` is written on the wire and on disk, so the generator
must stay identical with the reference's: stripes written by either client
decode under the other.

The reference has NO erasure-coding data path (EC exists only as a placement
option in deploy/data_placement/src/model/data_placement.py:484); RS(8+2)
encode/decode is a capability t3fs adds per BASELINE.json.  Construction is
the standard systematic one (row-reduced Vandermonde, any k of k+m rows
invertible).  The hot path is the GF(2) expansion: for byte position j across
shards, parity bits = Gbits @ data bits, i.e. a (positions, 8k) @ (8k, 8m)
matmul — MXU-shaped and batched over arbitrarily many positions.
"""

from __future__ import annotations

import functools

import numpy as np

from t3fs_torch.ops.gf256 import GF256, default_field


class RSCode:
    """RS(k+m): shards 0..k-1 are data, k..k+m-1 are parity."""

    def __init__(self, k: int = 8, m: int = 2, field: GF256 | None = None):
        self.k = k
        self.m = m
        self.gf = field or default_field()
        if m == 2 and k <= 254:
            # RAID-6-style rows: P = XOR of all shards, Q = Horner chain in
            # the generator (coefficients g^(k-1-s)).  MDS for k <= 254
            # (distinct nonzero coefficients; the 2x2 minors [[1,1],[g^a,
            # g^b]] are invertible).  Chosen over row-reduced Vandermonde
            # because encode becomes k-1 XORs + k-1 xtimes on PACKED WORDS
            # — ~8x faster than the GF(2) bit matmul on the VPU
            # (jax_codec.make_rs_encode fast path).
            self.raid6 = True
            G = np.zeros((k + 2, k), dtype=np.uint8)
            G[:k] = np.eye(k, dtype=np.uint8)
            G[k, :] = 1
            G[k + 1, :] = [self.gf.pow(2, k - 1 - s) for s in range(k)]
            self.G = G
            # identifies the parity FORMAT on the wire/disk: decode with a
            # different generator matrix silently corrupts, so layouts
            # carry this id and clients cross-check it
            self.code_id = f"raid6-g2-{self.gf.poly:x}"
        else:
            self.raid6 = False
            self.G = self.gf.systematic_generator(k, m)      # (k+m, k) GF(2^8)
            self.code_id = f"rrvand-{self.gf.poly:x}"
        self.parity_rows = self.G[k:]                        # (m, k)
        # (8k, 8m) 0/1 matrix: unpacked data bits @ this = parity bits
        self.parity_bitmatrix = np.ascontiguousarray(
            self.gf.gfmat_to_bitmatrix(self.parity_rows).T
        )
        self._recon_cache: dict = {}  # per-instance memo (no global pinning)

    # --- host/numpy oracle path ---

    def encode_ref(self, data: np.ndarray) -> np.ndarray:
        """data: (k, L) uint8 -> parity (m, L) uint8. Numpy GF math (oracle)."""
        data = np.asarray(data, dtype=np.uint8)
        assert data.shape[0] == self.k
        out = np.zeros((self.m, data.shape[1]), dtype=np.uint8)
        for p in range(self.m):
            acc = np.zeros(data.shape[1], dtype=np.uint8)
            for i in range(self.k):
                acc ^= self.gf.mul(self.parity_rows[p, i], data[i])
            out[p] = acc
        return out

    def reconstruct_gfmatrix(self, present: list[int], want: list[int]) -> np.ndarray:
        """GF(2^8) matrix W (len(want) x k) with shards[want] = W @ shards[present].

        `present` must list exactly k distinct shard indices (0..k+m-1); any k
        suffice by the systematic-Vandermonde property."""
        assert len(present) == self.k
        sub = self.G[np.array(present)]                      # (k, k)
        inv = self.gf.mat_inv(sub)                           # data = inv @ present
        return self.gf.matmul(self.G[np.array(want)], inv)   # want = G[want] @ data

    def _recon_cached(self, present: tuple[int, ...], want: tuple[int, ...]):
        v = self._recon_cache.get((present, want))
        if v is None:
            W = self.reconstruct_gfmatrix(list(present), list(want))
            v = self._recon_cache[(present, want)] = (
                W, np.ascontiguousarray(self.gf.gfmat_to_bitmatrix(W).T))
        return v

    def reconstruct_bitmatrix(self, present: list[int], want: list[int]) -> np.ndarray:
        """(8k, 8*len(want)) 0/1 matrix for the bit-matmul decode path."""
        return self._recon_cached(tuple(present), tuple(want))[1]

    def decode_ref(self, shards: dict[int, np.ndarray], want: list[int]) -> np.ndarray:
        """Reconstruct `want` shard rows from any k present shards (oracle)."""
        present = sorted(shards.keys())[: self.k]
        W = self._recon_cached(tuple(present), tuple(want))[0]
        L = next(iter(shards.values())).shape[0]
        out = np.zeros((len(want), L), dtype=np.uint8)
        for r in range(len(want)):
            acc = np.zeros(L, dtype=np.uint8)
            for c, idx in enumerate(present):
                acc ^= self.gf.mul(W[r, c], shards[idx])
            out[r] = acc
        return out


@functools.lru_cache(maxsize=None)
def default_rs(k: int = 8, m: int = 2) -> RSCode:
    return RSCode(k, m)
