"""A numpy model, lane by lane, of the tensor-core CRC product that the
port's CRC kernels share (t3fs_torch/csrc/crc_common.cuh): operand A's
fragments, mma.sync m16n8k256 b1 and.popc by PTX's fragment layout, the
epilogue, and the Horner fold of a run.  The word kernel's tests
(test_torch_cuda_codec.py) and the byte kernel's (test_torch_crc_bytes.py)
feed it their own operand B."""

import numpy as np

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


def k_word(ks, t):
    """The segment word k-step ks of lane t pairs with its b0 (b1: +1)."""
    return 16 * (ks >> 1) + 4 * t + 2 * (ks & 1)


def mma_b1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync m16n8k256 b1 and.popc on the lanes' registers, by PTX's
    fragment layout with bit i of a register as element i (b1_probe.py):
    a (..., 32, 4), b (..., 32, 2) u32 -> d (..., 32, 4) with d[lane, r] =
    D[g + 8 (r >> 1), 2 t + (r & 1)]."""
    r = np.arange(4)
    tp, h = np.arange(4), np.arange(2)
    a_lane = 4 * G[:, None, None, None] + tp[None, None, :, None]       # (32,1,4,1)
    a_reg = (r[None, :, None, None] >> 1) + 2 * h[None, None, None, :]  # (1,4,1,2)
    col = 2 * T[:, None] + (r[None, :] & 1)                             # (32,4)
    b_lane = 4 * col[:, :, None, None] + tp[None, None, :, None]        # (32,4,4,1)
    prod = a[..., a_lane, a_reg] & b[..., b_lane, h[None, None, None, :]]
    return np.bitwise_count(prod).sum(axis=(-1, -2)).astype(np.int64)


def a_fragments(tables) -> np.ndarray:
    """(2, 16, 32, 4) u32: the kernels' shared A, [m-tile][k-step][lane][r],
    from the tables' crc_mma_a."""
    A = tables.crc_mma_a.numpy().view(np.uint32).reshape(32, 128)
    mt, ks, lane, r = np.meshgrid(np.arange(2), np.arange(16), LANE, np.arange(4),
                                  indexing="ij")
    row = 16 * mt + lane // 4 + 8 * (r & 1)
    return A[row, k_word(ks, lane % 4) + (r >> 1)]


def unit_crcs(frags: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """mma_chunk over the 8 chunks, then unit_epilogue: (U, 16, 128) u32
    units (zeros past their columns) -> (U, 16) u32 segment CRCs, as the
    lanes hold them after the epilogue."""
    U = segs.shape[0]
    d = np.zeros((U, 2, 2, 32, 4), dtype=np.int64)          # [u, mt, nt, lane, c]
    for ks in range(16):
        for nt in range(2):
            # lane (g, t) holds chunk 4q + t of segment 8 nt + g: words
            # 16q + 4t .. +3; k-step ks takes components 2(ks % 2), +1
            w0 = k_word(ks, T)
            b = np.stack([segs[:, 8 * nt + G, w0], segs[:, 8 * nt + G, w0 + 1]], -1)
            for mt in range(2):
                d[:, mt, nt] += mma_b1(frags[mt, ks], b)
    out = np.zeros((U, 16), dtype=np.uint32)
    for nt in range(2):
        for p in range(2):
            x = (((d[:, 0, nt, :, p] & 1) << G) | ((d[:, 0, nt, :, p + 2] & 1) << (G + 8))
                 | ((d[:, 1, nt, :, p] & 1) << (G + 16))
                 | ((d[:, 1, nt, :, p + 2] & 1) << (G + 24)))
            for t in range(4):                               # OR the 8 lanes of t
                out[:, 8 * nt + 2 * t + p] = np.bitwise_or.reduce(x[:, T == t], axis=1)
    return out


def fold_run(tables, crcs, ncols: int, s_last: int) -> int:
    """fold_run: the Horner fold acc = Mb^512 . acc ^ seg over a run's first
    ncols segment CRCs, Mb^512 as four byte lookups (seg_shift_bytes), then
    P[s_last] (combine_cols) as a GF(2) matrix-vector product."""
    shift = tables.seg_shift_bytes.numpy().view(np.uint32).reshape(4, 256)
    col = tables.combine_cols.numpy().view(np.uint32)[s_last]
    acc = 0
    for c in range(ncols):
        acc = (int(shift[0][acc & 255]) ^ int(shift[1][(acc >> 8) & 255])
               ^ int(shift[2][(acc >> 16) & 255]) ^ int(shift[3][acc >> 24])
               ^ int(crcs[c]))
    y = 0
    for i in range(32):
        if (acc >> i) & 1:
            y ^= int(col[i])
    return y
