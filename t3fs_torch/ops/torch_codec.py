"""Batched CRC32C + RS(k+m) in plain PyTorch: the twin of t3fs/ops/jax_codec.py.

The same GF(2) formulation as the reference: bytes unpack to 0/1 bit
planes, CRC32C and the RS parity equations become 0/1 matrix products,
and a mod 2 recovers the GF(2) result.  The products run in float32, which
is exact here: every sum counts at most 8*segment (4096) or 32*segments
ones, far below 2^24, and torch has no integer matmul on CUDA.

It is the twin of the XLA programs, not a route of the codec: TorchECCodec
runs the CUDA kernels of cuda_codec on every route, for codes that are not
RAID-6 and odd lengths too.  These functions stay as an oracle that shares
no arithmetic with the kernels' plain versions (the tests and chip_smoke
hold kernel outputs against them).

Conventions: torch has no unsigned 32-bit arithmetic on the CPU, so every
uint32 value (CRC, packed word) is carried as the int32 tensor with the same
bits; `.numpy().view(np.uint32)` reads it back.  Right shifts on int32 fill
from the sign bit, so each one is followed by a mask.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from t3fs_torch import resolve_device
from t3fs_torch.ops.crc32c import default_matrices
from t3fs_torch.ops.rs import RSCode, default_rs

DEFAULT_SEG_BYTES = 512


def i32(v: int) -> int:
    """The int32 with the same bits as the uint32 value v."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 (..., B) -> int8 (..., 8B), LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8).to(torch.int8)


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (..., 32) -> int32 (...) holding the packed uint32 bits."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.to(torch.int64) * weights).sum(-1)
    return (v - ((v >> 31) & 1) * (1 << 32)).to(torch.int32)


def pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (..., 8B) -> uint8 (..., B)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.int32)
    weights = torch.ones(8, dtype=torch.int32, device=bits.device) \
        << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def _mod2(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32) & 1


def make_crc32c_raw(padded_len: int, seg_bytes: int = DEFAULT_SEG_BYTES,
                    device: str | torch.device = "cuda"):
    """(n, padded_len) uint8 chunks -> (n, 32) int32 0/1 raw CRC (no
    init/final affine); the core the batch CRC and the stripe step share."""
    if padded_len % seg_bytes:
        raise ValueError(f"padded_len {padded_len} not a multiple of "
                         f"{seg_bytes}")
    dev = resolve_device(device)
    mats = default_matrices()
    nseg = padded_len // seg_bytes
    Lj = torch.from_numpy(mats.segment_matrix(seg_bytes).astype(np.float32)
                          ).to(dev)                                  # (8B, 32)
    Pj = torch.from_numpy(mats.combine_stack(nseg, seg_bytes)
                          .astype(np.float32)).to(dev)               # (S, 32, 32)

    def raw(chunks: torch.Tensor) -> torch.Tensor:
        n = chunks.shape[0]
        bits = unpack_bits(chunks.reshape(n, nseg, seg_bytes)).float()
        seg_crc = _mod2(bits @ Lj).float()                           # (n, S, 32)
        return _mod2(torch.einsum("skl,nsl->nk", Pj, seg_crc))       # (n, 32)

    return raw


def make_crc32c_batch(chunk_len: int, seg_bytes: int = DEFAULT_SEG_BYTES,
                      device: str | torch.device = "cuda"):
    """(n, chunk_len) uint8 -> (n,) int32 CRC32C bits, any length.

    Raw CRC is zero-preserving, so chunks are front-padded to whole
    segments while the affine constant uses the true length."""
    nseg = -(-chunk_len // seg_bytes)
    pad = nseg * seg_bytes - chunk_len
    raw = make_crc32c_raw(nseg * seg_bytes, seg_bytes, device)
    affine = i32(default_matrices().affine_const(chunk_len))

    def crc(chunks: torch.Tensor) -> torch.Tensor:
        if pad:
            chunks = F.pad(chunks, (pad, 0))
        return pack_bits_u32(raw(chunks)) ^ affine

    return crc


# --- Reed-Solomon ---

def xtimes_i32(x: torch.Tensor, poly_low: int) -> torch.Tensor:
    """SWAR multiply-by-x of four packed GF(2^8) bytes per int32 lane.

    The per-byte high bits land at byte bit 0 after the masked shift, so
    multiplying that 0/1 mask by the poly's low byte spreads the reduction
    into each byte with no carry across bytes."""
    hi = (x >> 7) & 0x01010101
    return ((x << 1) & i32(0xFEFEFEFE)) ^ (hi * poly_low)


def make_rs_encode_raid6(rs: RSCode, device: str | torch.device = "cuda"):
    """Encode for the m=2 RAID-6 code on packed words: P = XOR fold,
    Q = Horner fold in xtimes.  (n, k, L) uint8, L % 4 == 0 -> (n, 2, L)."""
    if not rs.raid6:
        raise ValueError("the word encoder needs the RAID-6 m=2 code")
    resolve_device(device)
    low = rs.gf.poly & 0xFF

    def encode(data: torch.Tensor) -> torch.Tensor:
        n, k, Lb = data.shape
        if Lb % 4:
            raise ValueError(f"chunk length {Lb} not a multiple of 4")
        w = data.contiguous().view(torch.int32)                    # (n, k, L/4)
        p = w[:, 0]
        q = w[:, 0]
        for s in range(1, k):
            p = p ^ w[:, s]
            q = xtimes_i32(q, low) ^ w[:, s]
        return torch.stack([p, q], dim=1).view(torch.uint8)        # (n, 2, L)

    return encode


def make_rs_encode(rs: RSCode | None = None,
                   device: str | torch.device = "cuda"):
    """(n, k, L) uint8 data shards -> (n, m, L) parity shards: the RAID-6
    word path where the length allows it, else the bit matmul."""
    rs = rs or default_rs()
    if not rs.raid6:
        return make_rs_encode_matmul(rs, device)
    fast = make_rs_encode_raid6(rs, device)
    slow = make_rs_encode_matmul(rs, device)

    def encode(data: torch.Tensor) -> torch.Tensor:
        return fast(data) if data.shape[-1] % 4 == 0 else slow(data)

    return encode


def make_rs_encode_matmul(rs: RSCode | None = None,
                          device: str | torch.device = "cuda"):
    """Bit-matmul encoder, any (k, m)."""
    rs = rs or default_rs()
    dev = resolve_device(device)
    B = torch.from_numpy(rs.parity_bitmatrix.astype(np.float32)).to(dev)  # (8k, 8m)

    def encode(data: torch.Tensor) -> torch.Tensor:
        bits = unpack_bits(data.transpose(1, 2)).float()           # (n, L, 8k)
        parity = pack_bits_u8(_mod2(bits @ B))                     # (n, L, m)
        return parity.transpose(1, 2).contiguous()

    return encode


def make_rs_reconstruct(present: tuple[int, ...], want: tuple[int, ...],
                        rs: RSCode | None = None,
                        device: str | torch.device = "cuda"):
    """(n, k, L) uint8 present shards (rows in `present` order) ->
    (n, |want|, L) uint8: the bit-matmul decode, any (k, m) and any L."""
    rs = rs or default_rs()
    dev = resolve_device(device)
    W = torch.from_numpy(rs.reconstruct_bitmatrix(list(present), list(want))
                         .astype(np.float32)).to(dev)              # (8k, 8w)

    def reconstruct(shards: torch.Tensor) -> torch.Tensor:
        bits = unpack_bits(shards.transpose(1, 2)).float()         # (n, L, 8k)
        out = pack_bits_u8(_mod2(bits @ W))                        # (n, L, w)
        return out.transpose(1, 2).contiguous()

    return reconstruct


def make_stripe_encode_step(chunk_len: int, k: int = 8, m: int = 2,
                            seg_bytes: int = DEFAULT_SEG_BYTES,
                            device: str | torch.device = "cuda"):
    """(n, k, chunk_len) uint8 stripes -> parity (n, m, chunk_len) uint8 and
    CRC32C of all k+m shards (n, k+m) int32 bits, data first."""
    if chunk_len % seg_bytes:
        raise ValueError(f"chunk_len {chunk_len} not a multiple of "
                         f"{seg_bytes}")
    rs_enc = make_rs_encode_matmul(default_rs(k, m), device)
    raw = make_crc32c_raw(chunk_len, seg_bytes, device)
    affine = i32(default_matrices().affine_const(chunk_len))

    def step(stripes: torch.Tensor):
        n = stripes.shape[0]
        parity = rs_enc(stripes)
        allsh = torch.cat([stripes, parity], dim=1)                # (n, k+m, L)
        crcs = (pack_bits_u32(raw(allsh.reshape(n * (k + m), chunk_len)))
                ^ affine).reshape(n, k + m)
        return parity, crcs

    return step
