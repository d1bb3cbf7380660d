"""Codec constants: the port's counterpart of a model's weights.

`build_codec_tables` builds, from the port's own copies of the numpy
builders, the arrays in the JAX package's own formats:

  crc_word_weights  (32, 128, 32) f32  pallas_codec._crc_word_weights()
  combine_stack     (S, 32, 32) u8     Crc32cMatrix.combine_stack(S, 512)
  seg_shift         (32, 32) u8        Crc32cMatrix.shift_matrix(512)
  chunk_affine      () u32             Crc32cMatrix.affine_const(S * 512)
  rs_G              (k+m, k) u8        RSCode.G
  rs_parity_bitmatrix (8k, 8m) u8      RSCode.parity_bitmatrix
  rs_code_id        () str             RSCode.code_id
  rs_poly           () int64           RSCode.gf.poly

`load_codec_tables` turns such a dict -- this package's, or one filled from
the JAX package, which is how the tests hold the two against each other --
into the tensors the kernels and their plain versions read.  The kernels
take their constants from a CodecTables and nowhere else.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.ops.crc32c import default_matrices
from t3fs_torch.ops.rs import default_rs

SEG_BYTES = 512                 # one CRC segment
SEG_WORDS = SEG_BYTES // 4      # = 128 uint32 words


def _crc_word_weights() -> np.ndarray:
    """(32, 128, 32) f32: weight slice for bit b of byte c of each word;
    index c*8+b, rows are segment_matrix rows 8*(4w+c)+b."""
    Lseg = default_matrices().segment_matrix(SEG_BYTES)          # (4096, 32)
    out = np.zeros((32, SEG_WORDS, 32), dtype=np.float32)
    for c in range(4):
        for b in range(8):
            rows = 8 * (4 * np.arange(SEG_WORDS) + c) + b
            out[c * 8 + b] = Lseg[rows]
    return out


def build_codec_tables(nseg: int = 1, k: int = 8, m: int = 2
                       ) -> dict[str, np.ndarray]:
    """The codec constants for chunks of `nseg` 512-byte segments and the
    RS(k+m) code, in the JAX package's formats (see the module doc)."""
    mats = default_matrices()
    rs = default_rs(k, m)
    return {
        "crc_word_weights": _crc_word_weights(),
        "combine_stack": mats.combine_stack(nseg, SEG_BYTES),
        "seg_shift": mats.shift_matrix(SEG_BYTES),
        "chunk_affine": np.array(mats.affine_const(nseg * SEG_BYTES),
                                 dtype=np.uint32),
        "rs_G": rs.G,
        "rs_parity_bitmatrix": rs.parity_bitmatrix,
        "rs_code_id": np.array(rs.code_id),
        "rs_poly": np.array(rs.gf.poly, dtype=np.int64),
    }


def _pack_columns(M: np.ndarray) -> np.ndarray:
    """(..., 32, 32) 0/1 GF(2) matrices -> (..., 32) int32: entry i holds
    column i packed, bit r = M[r, i]."""
    w = np.uint64(1) << np.arange(32, dtype=np.uint64)
    cols = (M.astype(np.uint64) * w[:, None]).sum(axis=-2)
    return cols.astype(np.uint32).view(np.int32)


def _nibble_table(weights: np.ndarray) -> np.ndarray:
    """The CRC word kernel's lookup table, (8, 16, 4, 32) int32 flattened.

    Entry [j][v][w % 4][w // 4] is the XOR of the packed CRC columns of the
    set bits of nibble value v at bits 4j..4j+3 of word w.  The layout puts
    the word's lane (w // 4, the lane that loads words 4l..4l+3 as one
    16-byte vector) innermost, so a warp's 32 lookups hit 32 banks."""
    cols = _pack_columns(weights.transpose(1, 2, 0)).view(np.uint32)  # [w, bit]
    table = np.zeros((8, 16, 4, 32), dtype=np.uint32)
    for j in range(8):
        for v in range(16):
            acc = np.zeros(SEG_WORDS, dtype=np.uint32)
            for t in range(4):
                if (v >> t) & 1:
                    acc ^= cols[:, 4 * j + t]
            table[j, v] = acc.reshape(32, 4).T                   # [w%4][w//4]
    return table.reshape(-1).view(np.int32)


@dataclass(frozen=True)
class CodecTables:
    """Device tensors of one codec configuration (chunk of `nseg` segments,
    RS(rs_k + rs_m)).  Plain versions read the matrix forms; the kernels
    read the packed-column forms."""

    device: torch.device
    nseg: int
    crc_word_weights: torch.Tensor   # (32, 128, 32) f32: plain B1
    crc_nibble_table: torch.Tensor   # (16384,) int32: kernel B1
    combine_stack: torch.Tensor      # (S, 32, 32) f32: plain combine
    combine_cols: torch.Tensor       # (S, 32) int32: kernel combine
    seg_shift_cols: torch.Tensor     # (32,) int32: kernel combine (Horner step)
    chunk_affine: int                # uint32 affine of an S*512-byte chunk
    rs_k: int
    rs_m: int
    rs_raid6: bool
    rs_poly_low: int                 # xtimes reduction byte (0x1D)
    rs_parity_bitmatrix: torch.Tensor  # (8k, 8m) f32
    rs_code_id: str


def load_codec_tables(arrays: dict[str, np.ndarray],
                      device: str | torch.device = "cuda") -> CodecTables:
    dev = resolve_device(device)
    weights = np.asarray(arrays["crc_word_weights"], dtype=np.float32)
    stack = np.asarray(arrays["combine_stack"], dtype=np.uint8)
    G = np.asarray(arrays["rs_G"], dtype=np.uint8)
    code_id = str(np.asarray(arrays["rs_code_id"]))
    rs_k = G.shape[1]

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return CodecTables(
        device=dev,
        nseg=stack.shape[0],
        crc_word_weights=t(weights),
        crc_nibble_table=t(_nibble_table(weights)),
        combine_stack=t(stack.astype(np.float32)),
        combine_cols=t(_pack_columns(stack)),
        seg_shift_cols=t(_pack_columns(np.asarray(arrays["seg_shift"]))),
        chunk_affine=int(np.asarray(arrays["chunk_affine"])),
        rs_k=rs_k,
        rs_m=G.shape[0] - rs_k,
        rs_raid6=code_id.startswith("raid6-"),
        rs_poly_low=int(np.asarray(arrays["rs_poly"])) & 0xFF,
        rs_parity_bitmatrix=t(np.asarray(arrays["rs_parity_bitmatrix"],
                                         dtype=np.float32)),
        rs_code_id=code_id,
    )


def codec_tables(nseg: int = 1, k: int = 8, m: int = 2,
                 device: str | torch.device = "cuda") -> CodecTables:
    """load_codec_tables(build_codec_tables(...)): the port's own constants."""
    return load_codec_tables(build_codec_tables(nseg, k, m), device)
