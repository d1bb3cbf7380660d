"""CRC-32C (Castagnoli) as GF(2) linear algebra.

The port's own copy of t3fs/ops/crc32c.py (t3fs_torch never imports the JAX
package); it must stay bit-identical with it.

The reference computes CRC32C per 1 MiB block on CPU with folly::crc32c and
append-combines with crc32c_combine (src/fbs/storage/Common.h:113-196).  We
keep the identical semantics (init 0xFFFFFFFF, reflected, final xor; combine
for appends) but reformulate for TPU:

  crc(m) is affine over GF(2) in the message bits.  With R the one-bit shift
  round matrix and Mb = R^8 the one-byte shift:

    crc_raw(m, init=s) = Mb^len @ s  ^  sum_i Mb^(len-1-i) @ ByteMat @ bits(m_i)
    crc(m)             = crc_raw(m, 0xFFFFFFFF) ^ 0xFFFFFFFF

  Splitting a chunk into S segments of B bytes, every segment's linear part is
  the SAME (8B x 32) matrix L_B, so a batch of chunks reduces to:

    seg_crcs  = unpack_bits(chunks) @ L_B.T          # (n, S, 32)  MXU matmul
    raw       = sum_s P[s] @ seg_crcs[:, s]          # (n, 32)     tiny einsum
    crc       = pack_bits(raw) ^ affine_const(len)

  and the combine identity is crc(a||b) = Mb^len(b) @ crc(a) ^ crc(b)
  (proved by expanding the affine parts; verified in tests against the scalar
  reference and the 0xE3069283 check vector).
"""

from __future__ import annotations

import functools

import numpy as np

from t3fs_torch.ops.gf256 import gf2_matmul, gf2_matpow, bits_of_u32, u32_of_bits

CRC32C_POLY_REFLECTED = 0x82F63B78


@functools.lru_cache(maxsize=None)
def _table() -> np.ndarray:
    tbl = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (CRC32C_POLY_REFLECTED if crc & 1 else 0)
        tbl[i] = crc
    return tbl


def crc32c_ref(data: bytes | np.ndarray, crc: int = 0) -> int:
    """Scalar table-driven CRC-32C, the correctness oracle (crc arg allows
    streaming continuation, same contract as folly::crc32c)."""
    return crc32c_raw_ref(data, (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF) ^ 0xFFFFFFFF


def crc32c_raw_ref(data: bytes, init: int = 0) -> int:
    """The linear core: no init inversion, no final xor."""
    tbl = _table()
    state = init & 0xFFFFFFFF
    for b in bytes(data):
        state = (state >> 8) ^ int(tbl[(state ^ b) & 0xFF])
    return state


class Crc32cMatrix:
    """Host-side builder of the GF(2) matrices consumed by the TPU path."""

    def __init__(self) -> None:
        # One-bit round: state' = (state >> 1) ^ (state & 1) * POLY
        R = np.zeros((32, 32), dtype=np.uint8)
        for k in range(31):
            R[k, k + 1] = 1
        poly_bits = bits_of_u32(CRC32C_POLY_REFLECTED)
        R[:, 0] ^= poly_bits
        self.Mbyte = gf2_matpow(R, 8)           # shift state by one byte
        self.ByteMat = self.Mbyte[:, :8].copy() # inject one message byte
        self._cache: dict = {}                  # per-instance memo (no global pinning)

    def _memo(self, key, build):
        v = self._cache.get(key)
        if v is None:
            v = self._cache[key] = build()
        return v

    def shift_matrix(self, nbytes: int) -> np.ndarray:
        """Mb^nbytes: 32x32 GF(2) matrix shifting a CRC past nbytes of data."""
        return self._memo(("shift", nbytes), lambda: gf2_matpow(self.Mbyte, nbytes))

    def segment_matrix(self, seg_bytes: int) -> np.ndarray:
        """L_B.T, shape (8*B, 32): raw CRC of one B-byte segment as a matmul
        over its LSB-first unpacked bits."""
        def build():
            L = np.zeros((32, 8 * seg_bytes), dtype=np.uint8)
            cur = self.ByteMat
            for j in range(seg_bytes - 1, -1, -1):
                L[:, 8 * j : 8 * j + 8] = cur
                cur = gf2_matmul(self.Mbyte, cur)
            return np.ascontiguousarray(L.T)
        return self._memo(("seg", seg_bytes), build)

    def combine_stack(self, num_segments: int, seg_bytes: int) -> np.ndarray:
        """P, shape (S, 32, 32): P[s] = Mb^(B*(S-1-s)), so that
        raw(chunk) = xor_s P[s] @ raw(segment_s)."""
        def build():
            step = self.shift_matrix(seg_bytes)
            P = np.zeros((num_segments, 32, 32), dtype=np.uint8)
            cur = np.eye(32, dtype=np.uint8)
            for s in range(num_segments - 1, -1, -1):
                P[s] = cur
                cur = gf2_matmul(step, cur)
            return P
        return self._memo(("comb", num_segments, seg_bytes), build)

    def affine_const(self, nbytes: int) -> int:
        """crc(m) = raw_linear(m) ^ affine_const(len): the init/final-xor term,
        = Mb^len @ 0xFFFFFFFF ^ 0xFFFFFFFF."""
        def build():
            shifted = gf2_matmul(self.shift_matrix(nbytes), bits_of_u32(0xFFFFFFFF)[:, None])
            return u32_of_bits(shifted[:, 0]) ^ 0xFFFFFFFF
        return self._memo(("affine", nbytes), build)

    def combine(self, crc_a: int, crc_b: int, len_b: int) -> int:
        """crc(a || b) from crc(a), crc(b), len(b) — the crc32c_combine
        equivalent used for append writes (reference Common.h:191)."""
        shifted = gf2_matmul(self.shift_matrix(len_b), bits_of_u32(crc_a)[:, None])
        return u32_of_bits(shifted[:, 0]) ^ crc_b


@functools.lru_cache(maxsize=None)
def default_matrices() -> Crc32cMatrix:
    return Crc32cMatrix()


def crc32c_combine_ref(crc_a: int, crc_b: int, len_b: int) -> int:
    return default_matrices().combine(crc_a, crc_b, len_b)
