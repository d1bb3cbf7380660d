"""Device steps of the pm-msr coupled-layer code (ops/msr.py): twin of
t3fs/ops/msr_codec.py, consumed by TorchECCodec's "mencv", "mrep" and
"mdecv" keys.

  * make_msr_encode_step -- data shards -> coupled parity + CRC32C of all
    k+m shards.  The per-plane scalar RS is the RAID-6 fold over the whole
    (plane, lane) axis, so stage B is kernel B2 on the uncoupled shards;
    the couplings around it are constant GF(2^8) multiplies.
  * make_msr_repair_step -- the single-loss projection rebuild: d helper
    projections of beta sub-chunks -> the whole rebuilt chunk + its CRC32C.
    Stages A and C are constant multiplies, gathers and scatters; stage B is
    kernel B4 twice (the two scheduled decode rows over the plane batch).
  * make_msr_decode_step -- multi-loss and degraded full-k decode: the
    cached dense decode matrix as a GF(2) product over the flattened (slot,
    plane) symbols, then the CRCs.

Representation.  Where a sub-chunk is a whole number of words (sub % 4 ==
0) the glue runs SWAR on int32 words, four GF(2^8) bytes a lane, as the JAX
package's word path does; otherwise on uint8 bytes, as its byte path does.
Stage B takes int32 words either way: a chunk is alpha >= 4 sub-chunks, so
the flattened encode axis is always whole words, and the repair's plane
batch is zero-padded to whole words (as the odd-length repair route pads)
and cut back.  The CRCs are B1 on the word view where the chunk is whole
512-byte segments, else B6 (cuda_codec.make_crc32c_rows).  Each wrapper
runs its kernel on CUDA tensors and its plain version on CPU tensors.

What stays torch ops, as the JAX package leaves it outside Pallas: the
stage A/C constant multiplies, `where`, the gathers and scatters, and the
decode product.  The latter is a float32 matmul over 0/1 bit planes, exact
since each sum counts at most 8 * k * alpha (2048 for RS(8+2)) < 2^24 ones.
"""

from __future__ import annotations

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.ops.cuda_codec import make_crc32c_rows, repair_bytes, rs_raid6_words
from t3fs_torch.ops.msr import MSRCode
from t3fs_torch.ops.tables import codec_tables, plane_major_t, repair_tables
from t3fs_torch.ops.torch_codec import xtimes_i32

# the decode product's bit planes, float32, stay under this many bytes a call
_DECODE_PLANE_BYTES = 1 << 30


def _xtimes_u8(x: torch.Tensor, poly_low: int) -> torch.Tensor:
    """Multiply-by-x on uint8 lanes (byte-path twin of xtimes_i32)."""
    return (x << 1) ^ (((x >> 7) & 1) * poly_low)


def _make_mulc(words: bool, poly_low: int):
    """Constant GF(2^8) multiply on packed lanes: the XOR of the xtimes
    ladder rungs the constant's set bits select."""
    if words:
        def xt(x):
            return xtimes_i32(x, poly_low)
    else:
        def xt(x):
            return _xtimes_u8(x, poly_low)

    def mulc(x: torch.Tensor, c: int) -> torch.Tensor:
        if not 0 < c < 256:
            raise ValueError(f"constant {c} out of GF(2^8) range (or zero)")
        acc = None
        t = x
        for b in range(c.bit_length()):
            if (c >> b) & 1:
                acc = t if acc is None else acc ^ t
            if b + 1 < c.bit_length():
                t = xt(t)
        return acc

    return mulc


def _lanes(x: torch.Tensor, words: bool) -> torch.Tensor:
    """uint8 bytes -> the glue's lanes (int32 words or the bytes)."""
    return x.view(torch.int32) if words else x


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8) if x.dtype == torch.int32 else x


# --------------------------------------------------------------- encode

def make_msr_encode_step(code: MSRCode, chunk_len: int,
                         device: str | torch.device = "cuda"):
    """(n, k, chunk_len) uint8 raw data shards -> (parity (n, m, chunk_len)
    uint8, crcs (n, k+m) int32): the pm-msr twin of the stripe step."""
    dev = resolve_device(device)
    k, m, alpha, t = code.k, code.m, code.alpha, code.t
    sub = code.subchunk_len(chunk_len)
    words = sub % 4 == 0
    lanes = sub // 4 if words else sub
    mulc = _make_mulc(words, code.gf.poly & 0xFF)
    # perm[y] flips plane digit y; unpaired[s, z]: symbol (s, z) is uncoupled
    perm = [torch.from_numpy(np.arange(alpha) ^ (1 << y)).to(dev) for y in range(t)]
    unpaired = torch.tensor([[code.unpaired(s, z) for z in range(alpha)]
                             for s in range(k)], device=dev)
    ztop = torch.from_numpy((np.arange(alpha) & (1 << (t - 1))) != 0).to(dev)
    tables = codec_tables(1, k, m, device=dev)
    crc = make_crc32c_rows(chunk_len, dev)

    def step(stacked: torch.Tensor):
        n = stacked.shape[0]
        v = _lanes(stacked, words).reshape(n, k, alpha, lanes)
        # uncouple the data columns
        us = []
        for s in range(k):
            own = v[:, s]
            par = v[:, s ^ 1][:, perm[s >> 1]]
            mixed = mulc(own, code.inv_delta) ^ mulc(par, code.g_inv_delta)
            us.append(torch.where(unpaired[s][None, :, None], own, mixed))
        U = _bytes(torch.stack(us, dim=1)).reshape(n, k, chunk_len)
        # per-plane scalar RS == the RAID-6 fold over the whole axis (B2)
        pu = rs_raid6_words(U.view(torch.int32), tables).view(torch.uint8)
        pu = _lanes(pu, words).reshape(n, m, alpha, lanes)
        u8_, u9_ = pu[:, 0], pu[:, 1]
        # couple the parity column (y = t-1)
        zt = ztop[None, :, None]
        pt = perm[t - 1]
        p0 = torch.where(zt, u8_ ^ mulc(u9_[:, pt], code.gamma), u8_)
        p1 = torch.where(zt, u9_, mulc(u8_[:, pt], code.gamma) ^ u9_)
        parity = _bytes(torch.stack([p0, p1], dim=1)).reshape(n, m, chunk_len)
        dcrc = crc(stacked.reshape(n * k, chunk_len)).reshape(n, k)
        pcrc = crc(parity.reshape(n * m, chunk_len)).reshape(n, m)
        return parity, torch.cat([dcrc, pcrc], dim=1)

    return step


# --------------------------------------------------------------- repair

def make_msr_repair_step(code: MSRCode, f: int, chunk_len: int,
                         device: str | torch.device = "cuda"):
    """(n, d, beta_len) uint8 helper projections (survivors in ascending
    slot order, each its selected sub-chunks concatenated in ascending plane
    order) -> (rebuilt (n, chunk_len) uint8, crcs (n,) int32 of the whole
    rebuilt chunk): the pm-msr twin of the fused repair step."""
    dev = resolve_device(device)
    sch = code.schedule(f)
    d, npl, alpha = code.d, sch.npl, code.alpha
    sub = code.subchunk_len(chunk_len)
    beta_len = npl * sub
    words = sub % 4 == 0
    lanes = sub // 4 if words else sub
    mulc = _make_mulc(words, code.gf.poly & 0xFF)

    def idx(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64)).to(dev)

    copy_mask = torch.from_numpy(sch.copy_mask[:, :, None]).to(dev)
    src_own, src_pair = idx(sch.src_own.ravel()), idx(sch.src_pair.ravel())
    idx_f, idx_p = idx(sch.idx_f), idx(sch.idx_p)
    sel_z = idx([z for z in range(alpha) if sch.out_sel[z] >= 0])
    nonsel_z = idx([w for w, _, _ in sch.nonsel])
    nonsel_p2 = idx([p2 for _, p2, _ in sch.nonsel])
    nonsel_c = idx([c for _, _, c in sch.nonsel])
    c_up = code.gf_mul_const(code.inv_gamma, code.delta)
    rep_f = repair_tables(sch.prog_f, code.rs)
    rep_p = repair_tables(sch.prog_p, code.rs)
    crc = make_crc32c_rows(chunk_len, dev)

    def fold(rep, x: torch.Tensor) -> torch.Tensor:
        """B4 over (n, h, npl, lanes) -> (n, npl, lanes), on whole words."""
        n, h = x.shape[:2]
        out = repair_bytes(_bytes(x).reshape(n, h, beta_len), rep)
        return _lanes(out, words).reshape(n, npl, lanes)

    def step(stacked: torch.Tensor):
        n = stacked.shape[0]
        flat = _lanes(stacked, words).reshape(n, d * npl, lanes)
        # stage A: uncouple the helpers outside the failed column
        own = flat[:, src_own].reshape(n, code.k, npl, lanes)
        pr = flat[:, src_pair].reshape(n, code.k, npl, lanes)
        mixed = mulc(own, code.inv_delta) ^ mulc(pr, code.g_inv_delta)
        U = torch.where(copy_mask[None], own, mixed)
        # stage B: the two scheduled decode rows over the plane batch (B4)
        Uf = fold(rep_f, U[:, idx_f])
        Up = fold(rep_p, U[:, idx_p])
        # stage C: scatter the selected planes, fold the coupled ones
        out = torch.zeros((n, alpha, lanes), dtype=flat.dtype, device=flat.device)
        out[:, sel_z] = Uf
        out[:, nonsel_z] = (mulc(flat[:, nonsel_c], code.inv_gamma)
                            ^ mulc(Up[:, nonsel_p2], c_up))
        rebuilt = _bytes(out).reshape(n, chunk_len)
        return rebuilt, crc(rebuilt)

    return step


# --------------------------------------------------------------- decode

def decode_bitmatrix_t(code: MSRCode, present: tuple[int, ...],
                       want: tuple[int, ...]) -> np.ndarray:
    """(8 |want| alpha, 8 k alpha) plane-major bit matrix of the cached
    decode matrix (code.decode_matrix): the same map as the JAX step's
    gfmat_to_bitmatrix(M).T, built from one 8x8 block per field value."""
    M = code.decode_matrix(tuple(present), tuple(want))
    blocks = np.stack([code.gf.const_to_bitmatrix(c) for c in range(256)])
    r, c = M.shape
    bits = blocks[M].transpose(0, 2, 1, 3).reshape(8 * r, 8 * c)
    return plane_major_t(np.ascontiguousarray(bits.T))


def make_msr_decode_step(code: MSRCode, present: tuple[int, ...],
                         want: tuple[int, ...], chunk_len: int,
                         device: str | torch.device = "cuda"):
    """(n, k, chunk_len) uint8 stored bytes of the `present` slots ->
    (rebuilt (n, |want|, chunk_len) uint8, crcs (n, k + |want|) int32:
    survivors then rebuilt): the multi-loss / degraded-read step, reading
    exactly k full shards."""
    dev = resolve_device(device)
    k, alpha = code.k, code.alpha
    sub = code.subchunk_len(chunk_len)
    nw = len(want)
    ka, na = k * alpha, nw * alpha
    Mt = torch.from_numpy(decode_bitmatrix_t(code, present, want)
                          .astype(np.float32)).to(dev)          # (8 na, 8 ka)
    crc = make_crc32c_rows(chunk_len, dev)
    group = max(1, _DECODE_PLANE_BYTES // (8 * ka * sub * 4))

    def product(x: torch.Tensor) -> torch.Tensor:
        """(g, ka, sub) uint8 symbols -> (g, na, sub) uint8: unpack to
        plane-major 0/1 planes (index b*ka + i), one product, mod 2, repack."""
        g = x.shape[0]
        planes = torch.cat([(x >> b) & 1 for b in range(8)], dim=1).float()
        bits = (torch.matmul(Mt, planes).to(torch.int32) & 1).reshape(g, 8, na, sub)
        out = bits[:, 0]
        for b in range(1, 8):
            out = out | (bits[:, b] << b)
        return out.to(torch.uint8)

    def step(stacked: torch.Tensor):
        n = stacked.shape[0]
        x = stacked.reshape(n, ka, sub)
        rebuilt = torch.cat([product(x[i:i + group]) for i in range(0, n, group)]
                            ).reshape(n, nw, chunk_len)
        scrc = crc(stacked.reshape(n * k, chunk_len)).reshape(n, k)
        rcrc = crc(rebuilt.reshape(n * nw, chunk_len)).reshape(n, nw)
        return rebuilt, torch.cat([scrc, rcrc], dim=1)

    return step
