"""GF(2^8) arithmetic and GF(2) bit-matrix utilities (host-side, numpy).

The port's own copy of t3fs/ops/gf256.py (t3fs_torch never imports the JAX
package); it must stay bit-identical with it.

These run on the host at setup time only: building log/exp tables, systematic
Reed-Solomon generator matrices, decode (reconstruction) matrices, and the
GF(2) bit-matrix form of multiply-by-constant.  The hot path consumes only the
resulting small 0/1 matrices, as matmul operands on TPU.

Background: multiplication by a fixed constant c in GF(2^8) is linear over
GF(2): bytes are 8-bit vectors, and y = c*x is y_bits = M_c @ x_bits (mod 2)
where column k of M_c holds the bits of c * 2^k.  A whole RS parity equation
(m parities from k data shards, byte-wise) is then one (8k x 8m) 0/1 matrix.
"""

from __future__ import annotations

import functools

import numpy as np

# The conventional RS polynomial x^8+x^4+x^3+x^2+1 (0x11D), generator alpha=2.
RS_POLY = 0x11D


class GF256:
    """GF(2^8) field arithmetic with numpy-vectorized table ops."""

    def __init__(self, poly: int = RS_POLY):
        self.poly = poly
        exp = np.zeros(512, dtype=np.uint8)
        log = np.zeros(256, dtype=np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= poly
        exp[255:510] = exp[:255]  # wraparound so exp[(a+b) % 255] needs no mod
        self.exp = exp
        self.log = log

    def mul(self, a, b):
        """Element-wise GF multiply; accepts scalars or arrays."""
        a = np.asarray(a, dtype=np.uint8)
        b = np.asarray(b, dtype=np.uint8)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), np.uint8(0), out)

    def inv(self, a):
        a = np.asarray(a, dtype=np.uint8)
        if np.any(a == 0):
            raise ZeroDivisionError("GF256 inverse of 0")
        return self.exp[255 - self.log[a]]

    def pow(self, a: int, n: int):
        if a == 0:
            return 0 if n else 1
        return int(self.exp[(int(self.log[a]) * (n % 255)) % 255])

    def matmul(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        """GF(2^8) matrix product (small matrices, host only)."""
        A = np.asarray(A, dtype=np.uint8)
        B = np.asarray(B, dtype=np.uint8)
        # products[i,j,l] = A[i,l]*B[l,j]; XOR-reduce over l
        prod = self.mul(A[:, None, :], B.T[None, :, :])
        return np.bitwise_xor.reduce(prod, axis=2)

    def mat_inv(self, A: np.ndarray) -> np.ndarray:
        """Gauss-Jordan inverse over GF(2^8)."""
        A = np.array(A, dtype=np.uint8)
        n = A.shape[0]
        assert A.shape == (n, n)
        aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
        for col in range(n):
            piv = col + int(np.argmax(aug[col:, col] != 0))
            if aug[piv, col] == 0:
                raise np.linalg.LinAlgError("singular GF256 matrix")
            if piv != col:
                aug[[col, piv]] = aug[[piv, col]]
            aug[col] = self.mul(aug[col], self.inv(aug[col, col]))
            for r in range(n):
                if r != col and aug[r, col]:
                    aug[r] ^= self.mul(aug[r, col], aug[col])
        return aug[:, n:]

    def vandermonde(self, rows: int, cols: int) -> np.ndarray:
        """V[i,j] = alpha^(i*j)."""
        V = np.zeros((rows, cols), dtype=np.uint8)
        for i in range(rows):
            for j in range(cols):
                V[i, j] = self.pow(2, i * j)
        return V

    def systematic_generator(self, k: int, m: int) -> np.ndarray:
        """(k+m) x k systematic RS generator: top k rows identity, any k rows
        of the result are invertible (Vandermonde row-reduced, the standard
        Jerasure/ISA-L construction)."""
        V = self.vandermonde(k + m, k)
        top_inv = self.mat_inv(V[:k])
        G = self.matmul(V, top_inv)
        assert np.array_equal(G[:k], np.eye(k, dtype=np.uint8))
        return G

    def const_to_bitmatrix(self, c: int) -> np.ndarray:
        """8x8 GF(2) matrix M with bits(c*x) = M @ bits(x); bit k = (v>>k)&1."""
        M = np.zeros((8, 8), dtype=np.uint8)
        for kbit in range(8):
            v = int(self.mul(c, 1 << kbit))
            M[:, kbit] = [(v >> r) & 1 for r in range(8)]
        return M

    def gfmat_to_bitmatrix(self, A: np.ndarray) -> np.ndarray:
        """Expand an (r x c) GF(2^8) matrix to an (8r x 8c) GF(2) 0/1 matrix
        acting on bit-unpacked byte vectors (LSB-first within each byte)."""
        A = np.asarray(A, dtype=np.uint8)
        r, c = A.shape
        out = np.zeros((8 * r, 8 * c), dtype=np.uint8)
        for i in range(r):
            for j in range(c):
                if A[i, j]:
                    out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = self.const_to_bitmatrix(int(A[i, j]))
        return out


@functools.lru_cache(maxsize=None)
def default_field() -> GF256:
    return GF256()


# --- GF(2) bit-matrix helpers (numpy, host-side) ---

def gf2_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Matrix product mod 2 of 0/1 matrices."""
    return (A.astype(np.int64) @ B.astype(np.int64) % 2).astype(np.uint8)


def gf2_matpow(A: np.ndarray, n: int) -> np.ndarray:
    """A^n mod 2 by square-and-multiply."""
    result = np.eye(A.shape[0], dtype=np.uint8)
    base = A.copy()
    while n:
        if n & 1:
            result = gf2_matmul(result, base)
        base = gf2_matmul(base, base)
        n >>= 1
    return result


def bits_of_u32(v: int) -> np.ndarray:
    return np.array([(v >> k) & 1 for k in range(32)], dtype=np.uint8)


def u32_of_bits(bits: np.ndarray) -> int:
    return int(sum(int(b) << k for k, b in enumerate(np.asarray(bits).ravel())))
