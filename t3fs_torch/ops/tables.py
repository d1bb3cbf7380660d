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

The byte-path CRC (B6) has its own, from `build_crc_bytes_arrays` and
`load_crc_bytes_tables`: the segment matrix (plane-major for the plain
version, B1's operand A for the kernel) and the combine stack.

The read side's constants follow the same pattern.  A GF(2^8)-linear map of
k input shards to r output shards (a decode pattern, or the encode's parity
rows) is built by `build_decode_arrays` / `build_encode_arrays`:

  gfmatrix     (r, k) u8      RSCode.reconstruct_gfmatrix(present, want)
                              (or RSCode.parity_rows): kernel B3
  bitmatrix_t  (8r, 8k) u8    the plane-major, transposed bit matrix
                              pallas_codec feeds _rs_kernel (l.90-93,
                              465-468): kernel B5 and its plain version
  rs_poly      () int64       RSCode.gf.poly

and loaded by `load_gfmap_tables`, which cuts the map into B5's launches
(`b5_tile_plan`).  A repair program's `planes` (the port's repair_program,
or the JAX package's) load with `load_repair_tables`, which cuts the row
into B4's launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.ops.crc32c import default_matrices
from t3fs_torch.ops.repair_program import RepairProgram
from t3fs_torch.ops.rs import RSCode, default_rs

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


def _crc_mma_matrix(weights: np.ndarray) -> np.ndarray:
    """B1's operand A, the (32, 128) u32 CRC matrix flattened as int32: bit i
    of word w of row r is the weight of segment word w's bit i (message bit
    32w + i, little-endian) in CRC bit r, i.e. weights[i][w][r].  The tensor
    cores pair bit i of an A register with bit i of a B register
    (b1_probe.py), so the rows pair with the segment words as they lie in
    memory."""
    rows = _pack_columns(weights.transpose(1, 0, 2)).T          # [r, w]
    return np.ascontiguousarray(rows).reshape(-1)


def _byte_tables(M: np.ndarray) -> np.ndarray:
    """A (32, 32) GF(2) matrix as four byte lookups, (4, 256) int32
    flattened: entry [j][v] is M . (v << 8j) packed, so M . x is the XOR of
    the entries of x's four bytes."""
    cols = _pack_columns(M).view(np.uint32)
    v = np.arange(256)
    out = np.zeros((4, 256), dtype=np.uint32)
    for j in range(4):
        for b in range(8):
            out[j, ((v >> b) & 1) == 1] ^= cols[8 * j + b]
    return out.reshape(-1).view(np.int32)


@dataclass(frozen=True)
class CodecTables:
    """Device tensors of one codec configuration (chunk of `nseg` segments,
    RS(rs_k + rs_m)).  Plain versions read the matrix forms; the kernels
    read the packed forms."""

    device: torch.device
    nseg: int
    crc_word_weights: torch.Tensor   # (32, 128, 32) f32: plain B1
    crc_mma_a: torch.Tensor          # (4096,) int32 _crc_mma_matrix: kernel B1
    combine_stack: torch.Tensor      # (S, 32, 32) f32: plain combine
    combine_cols: torch.Tensor       # (S, 32) int32: kernel combine
    seg_shift_bytes: torch.Tensor    # (1024,) int32: kernel combine (Horner step)
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
        crc_mma_a=t(_crc_mma_matrix(weights)),
        combine_stack=t(stack.astype(np.float32)),
        combine_cols=t(_pack_columns(stack)),
        seg_shift_bytes=t(_byte_tables(np.asarray(arrays["seg_shift"]))),
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


# --- byte-path CRC (B6) -----------------------------------------------------

def crc_nseg(nbytes: int) -> int:
    """Segments of a row of `nbytes` front-padded to whole segments (an
    empty row is one all-padding segment, whose raw CRC is 0)."""
    return max(1, -(-nbytes // SEG_BYTES))


def build_crc_bytes_arrays(nseg: int = 1) -> dict[str, np.ndarray]:
    """B6's constants for rows of `nseg` segments, in the JAX package's
    formats:

      segment_matrix  (4096, 32) u8   Crc32cMatrix.segment_matrix(512)
      combine_stack   (S, 32, 32) u8  Crc32cMatrix.combine_stack(S, 512)
      seg_shift       (32, 32) u8     Crc32cMatrix.shift_matrix(512)
    """
    mats = default_matrices()
    return {
        "segment_matrix": mats.segment_matrix(SEG_BYTES),
        "combine_stack": mats.combine_stack(nseg, SEG_BYTES),
        "seg_shift": mats.shift_matrix(SEG_BYTES),
    }


@dataclass(frozen=True)
class CrcBytesTables:
    """Device tensors of B6 for rows of `nseg` segments.  The plain version
    reads the plane-major segment matrix and the combine stack; the kernel
    reads B1's packed forms (a segment's bytes are its words' bytes)."""

    device: torch.device
    nseg: int
    seg_matrix_pm: torch.Tensor      # (4096, 32) f32 Lseg[perm]: plain B6
    combine_stack: torch.Tensor      # (S, 32, 32) f32: plain combine
    crc_mma_a: torch.Tensor          # (4096,) int32 _crc_mma_matrix: kernel B6
    combine_cols: torch.Tensor       # (S, 32) int32: kernel combine
    seg_shift_bytes: torch.Tensor    # (1024,) int32: kernel combine (Horner step)


def load_crc_bytes_tables(arrays: dict[str, np.ndarray],
                          device: str | torch.device = "cuda") -> CrcBytesTables:
    """Arrays in build_crc_bytes_arrays' formats (this package's, or the JAX
    package's segment_matrix / combine_stack / shift_matrix) -> tensors."""
    dev = resolve_device(device)
    Lseg = np.asarray(arrays["segment_matrix"], dtype=np.uint8)
    stack = np.asarray(arrays["combine_stack"], dtype=np.uint8)
    if Lseg.shape != (8 * SEG_BYTES, 32):
        raise ValueError(f"segment_matrix {Lseg.shape} is not of a "
                         f"{SEG_BYTES}-byte segment")

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return CrcBytesTables(
        device=dev,
        nseg=stack.shape[0],
        seg_matrix_pm=t(Lseg[plane_major_perm(SEG_BYTES)].astype(np.float32)),
        combine_stack=t(stack.astype(np.float32)),
        # word w's bit i is byte 4w + i // 8's bit i % 8: Lseg row 32w + i
        crc_mma_a=t(_crc_mma_matrix(Lseg.reshape(SEG_WORDS, 32, 32)
                                    .transpose(1, 0, 2))),
        combine_cols=t(_pack_columns(stack)),
        seg_shift_bytes=t(_byte_tables(np.asarray(arrays["seg_shift"]))),
    )


def crc_bytes_tables(nseg: int = 1,
                     device: str | torch.device = "cuda") -> CrcBytesTables:
    """load_crc_bytes_tables(build_crc_bytes_arrays(...))."""
    return load_crc_bytes_tables(build_crc_bytes_arrays(nseg), device)


# --- read side: GF(2^8)-linear maps (B3, B5) and repair programs (B4) -------

def plane_major_perm(nbytes: int) -> np.ndarray:
    """Permutation p with p[b*nbytes + j] = j*8 + b (plane-major -> LSB-first);
    the port's copy of pallas_codec._plane_major_perm."""
    b, j = np.meshgrid(np.arange(8), np.arange(nbytes), indexing="ij")
    return (j * 8 + b).reshape(-1)


def plane_major_t(bitmatrix: np.ndarray) -> np.ndarray:
    """(8k, 8r) LSB-first bit matrix -> (8r, 8k) plane-major transpose:
    entry [b*r + j, b'*k + i] maps bit b' of input i to bit b of output j."""
    k8, r8 = bitmatrix.shape
    pk, pr = plane_major_perm(k8 // 8), plane_major_perm(r8 // 8)
    return np.ascontiguousarray(bitmatrix[np.ix_(pk, pr)].T)


def build_decode_arrays(present, want, rs: RSCode | None = None
                        ) -> dict[str, np.ndarray]:
    """The decode constants of one (present, want) pattern of RS(k+m)."""
    rs = rs or default_rs()
    present, want = list(present), list(want)
    return {
        "gfmatrix": rs.reconstruct_gfmatrix(present, want),
        "bitmatrix_t": plane_major_t(rs.reconstruct_bitmatrix(present, want)),
        "rs_poly": np.array(rs.gf.poly, dtype=np.int64),
    }


def build_encode_arrays(rs: RSCode | None = None) -> dict[str, np.ndarray]:
    """The encode's parity map of RS(k+m) in the same formats."""
    rs = rs or default_rs()
    return {
        "gfmatrix": rs.parity_rows,
        "bitmatrix_t": plane_major_t(rs.parity_bitmatrix),
        "rs_poly": np.array(rs.gf.poly, dtype=np.int64),
    }


def bitmatmul_lut(bitmatrix_t: np.ndarray) -> np.ndarray:
    """The byte-plane kernel's tables, (ceil(r/4), k, 256) int32 flattened.

    Entry [g][i][x] packs, in byte jj, output shard 4g+jj's share of input
    shard i holding byte value x: the 8x8 block of `bitmatrix_t` from input
    i's bit planes to output 4g+jj's, applied to the bits of x (mod 2)."""
    r8, k8 = bitmatrix_t.shape
    r, k = r8 // 8, k8 // 8
    M = np.asarray(bitmatrix_t, dtype=np.int64).reshape(8, r, 8, k)  # [b, j, b', i]
    xbits = (np.arange(256)[:, None] >> np.arange(8)) & 1            # [x, b']
    bits = np.einsum("xc,bjci->xbji", xbits, M) & 1                  # [x, b, j, i]
    byts = (bits << np.arange(8)[None, :, None, None]).sum(axis=1)   # [x, j, i]
    lut = np.zeros((-(-r // 4), k, 256), dtype=np.uint32)
    for j in range(r):
        lut[j // 4] |= byts[:, j, :].T.astype(np.uint32) << np.uint32(8 * (j % 4))
    return lut.reshape(-1).view(np.int32)


# What one launch of B5 (csrc/rs_bitmatmul.cu) takes: at most 8 output
# shards, and tables of at most the opt-in shared memory of a block on sm_90
# (227 KiB).  A larger map runs as several launches, one a tile.
B5_MAX_ROWS = 8
B5_MAX_TABLE_BYTES = 227 * 1024


def b5_tile_plan(k: int, rows: int) -> list[tuple[int, int, int, int]]:
    """The (i0, ki, j0, wj) tiles of a map of k input shards to `rows`
    output shards: output rows in groups of <= B5_MAX_ROWS and, per row
    group, input shards in as few equal groups as fit the table limit.
    Each tile adds input shards i0..i0+ki-1's share to output rows
    j0..j0+wj-1; a row group's first tile writes them, the others XOR in."""
    plan = []
    for j0 in range(0, rows, B5_MAX_ROWS):
        wj = min(B5_MAX_ROWS, rows - j0)
        kmax = B5_MAX_TABLE_BYTES // (-(-wj // 4) * 256 * 4)
        groups = -(-k // kmax)
        i0 = 0
        for gi in range(groups):
            ki = k // groups + (gi < k % groups)
            plan.append((i0, ki, j0, wj))
            i0 += ki
    return plan


@dataclass(frozen=True)
class B5Tile:
    """One launch of B5: input shards i0..i0+ki-1 to output rows
    j0..j0+rows-1 (accumulating unless i0 == 0)."""

    i0: int
    ki: int
    j0: int
    rows: int
    bitmatrix_t: torch.Tensor        # (8 rows, 8 ki) f32 plane-major block: plain tile
    lut: torch.Tensor                # (ceil(rows/4) * ki * 256,) int32: kernel tile


@dataclass(frozen=True)
class GFMapTables:
    """Constants of one GF(2^8)-linear map of k input shards to `rows`
    output shards.  B3 reads the coefficients, B5 its tiles (b5_tile_plan)
    and B5's plain version the whole bit matrix."""

    k: int
    rows: int
    coeff_rows: tuple[tuple[int, ...], ...]  # (rows, k) GF(2^8): B3
    poly_low: int                    # xtimes reduction byte (0x1D)
    bitmatrix_t: torch.Tensor        # (8 rows, 8k) f32 plane-major: plain B5
    tiles: tuple[B5Tile, ...]        # B5's launches


def load_gfmap_tables(arrays: dict[str, np.ndarray],
                      device: str | torch.device = "cuda") -> GFMapTables:
    """Arrays in build_decode_arrays' formats (this package's, or the JAX
    package's reconstruct_gfmatrix / plane-major bit matrix) -> tensors."""
    dev = resolve_device(device)
    G = np.ascontiguousarray(arrays["gfmatrix"], dtype=np.uint8)
    Mt = np.asarray(arrays["bitmatrix_t"], dtype=np.uint8)
    rows, k = G.shape
    if Mt.shape != (8 * rows, 8 * k):
        raise ValueError(f"bitmatrix_t {Mt.shape} does not match gfmatrix "
                         f"{G.shape}")
    M = Mt.reshape(8, rows, 8, k)
    tiles = []
    for i0, ki, j0, wj in b5_tile_plan(k, rows):
        block = M[:, j0:j0 + wj, :, i0:i0 + ki].reshape(8 * wj, 8 * ki)
        tiles.append(B5Tile(
            i0=i0, ki=ki, j0=j0, rows=wj,
            bitmatrix_t=torch.from_numpy(block.astype(np.float32)).to(dev),
            lut=torch.from_numpy(bitmatmul_lut(block)).to(dev)))
    return GFMapTables(
        k=k, rows=rows, coeff_rows=tuple(tuple(int(c) for c in row) for row in G),
        poly_low=int(np.asarray(arrays["rs_poly"])) & 0xFF,
        bitmatrix_t=torch.from_numpy(Mt.astype(np.float32)).to(dev),
        tiles=tuple(tiles),
    )


def decode_tables(present, want, rs: RSCode | None = None,
                  device: str | torch.device = "cuda") -> GFMapTables:
    """load_gfmap_tables(build_decode_arrays(...)): one decode pattern."""
    return load_gfmap_tables(build_decode_arrays(present, want, rs), device)


def encode_map_tables(rs: RSCode | None = None,
                      device: str | torch.device = "cuda") -> GFMapTables:
    """load_gfmap_tables(build_encode_arrays(...)): the parity map."""
    return load_gfmap_tables(build_encode_arrays(rs), device)


# What one launch of B4 (csrc/repair_words.cu) takes: at most 32 helpers
# (one bitmask word a plane).  A longer row runs as one launch a group.
B4_MAX_HELPERS = 32


@dataclass(frozen=True)
class RepairGroup:
    """One launch of B4: helpers h0..h0+count-1 (bit j of masks[b]: helper
    h0+j's coefficient has bit b set; masks[-1], the top plane, nonempty)."""

    h0: int
    count: int
    masks: tuple[int, ...]


@dataclass(frozen=True)
class RepairTables:
    """One scheduled repair row: plain B4 reads `planes`; the kernel runs
    `groups`, the row split into groups of <= B4_MAX_HELPERS helpers (the
    row is linear in its helpers, so the groups' results XOR together)."""

    num_helpers: int
    planes: tuple[tuple[int, ...], ...]
    groups: tuple[RepairGroup, ...]
    poly_low: int


def load_repair_tables(num_helpers: int, planes, poly: int) -> RepairTables:
    """From a RepairProgram's `num_helpers` and `planes` (this package's
    repair_program, or the JAX package's)."""
    planes = tuple(tuple(int(i) for i in p) for p in planes)
    if not planes or not planes[-1]:
        raise ValueError(f"planes {planes}: the top plane must be nonempty")
    if any(not 0 <= i < num_helpers for p in planes for i in p):
        raise ValueError(f"planes {planes} name a helper outside "
                         f"0..{num_helpers - 1}")
    groups = []
    for h0 in range(0, num_helpers, B4_MAX_HELPERS):
        count = min(B4_MAX_HELPERS, num_helpers - h0)
        masks = [sum(1 << (i - h0) for i in set(p) if h0 <= i < h0 + count)
                 for p in planes]
        while masks and not masks[-1]:
            masks.pop()
        if masks:                    # a group whose helpers all have 0 drops out
            groups.append(RepairGroup(h0=h0, count=count, masks=tuple(masks)))
    return RepairTables(num_helpers=num_helpers, planes=planes,
                        groups=tuple(groups), poly_low=int(poly) & 0xFF)


def repair_tables(program: RepairProgram,
                  rs: RSCode | None = None) -> RepairTables:
    """load_repair_tables of one of this package's RepairPrograms."""
    rs = rs or default_rs()
    return load_repair_tables(program.num_helpers, program.planes, rs.gf.poly)
