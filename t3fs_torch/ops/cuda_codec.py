"""The codec's CUDA kernels and the paths they serve: twin of
t3fs/ops/pallas_codec.py (l.248-691) and of its byte-plane _rs_kernel.

Hand-written CUDA kernels (t3fs_torch/csrc/), each with its plain PyTorch
version beside it and a launch counter:

  crc_words       B1: raw CRC32C of 512-byte segments (128 words) and the
                  chunk combine -- replaces _crc_words_kernel (pallas_codec.py:310)
                  and the combine matmul of make_crc32c_words_raw
  rs_raid6_words  B2: RAID-6 P/Q parity -- replaces _rs_raid6_words_kernel
                  (pallas_codec.py:261)
  rs_reconstruct_words
                  B3: RAID-6 decode of 1 or 2 shards on packed words (plane
                  sums, a Horner fold per row) -- replaces
                  _rs_reconstruct_words_kernel (pallas_codec.py:502); past
                  k = 32 the wrapper runs B5 on the words' byte view
  repair_words    B4: one scheduled repair row (Horner over bit planes) --
                  replaces _repair_words_kernel (pallas_codec.py:587); one
                  launch per group of <= 32 helpers, XOR-accumulated
  rs_bitmatmul    B5: byte-plane GF(2) map of any RS(k+m) code, encode or
                  decode -- replaces _rs_kernel (pallas_codec.py:68); one
                  launch per tile of <= 8 output shards and <= 227 KiB of
                  tables, XOR-accumulated over input groups
  crc_bytes       B6: raw CRC32C of byte rows of any length and alignment,
                  front-padded to whole segments, and the row combine, on
                  B1's tensor-core product -- replaces _crc_seg_kernel
                  (pallas_codec.py:116) and the combine einsum of
                  make_crc32c_raw_fast

Data contract (the reference's): the word kernels take the little-endian
uint32 view of the byte shards (byte j is byte j % 4 of word j // 4),
carried as int32 tensors with the same bits, so numpy's `arr.view(np.int32)`
goes in and `.numpy().view(np.uint32)` comes out.  CRCs come back the same
way.  B5 takes and returns uint8 byte shards, B6 uint8 byte rows.

A wrapper chooses by the tensor it is given: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (or raises).  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from t3fs_torch import resolve_device
from t3fs_torch.ops.blocks import pick_block
from t3fs_torch.ops.repair_program import RepairProgram
from t3fs_torch.ops.rs import RSCode, default_rs
from t3fs_torch.ops.crc32c import default_matrices
from t3fs_torch.ops.tables import (
    SEG_BYTES, SEG_WORDS, CodecTables, CrcBytesTables, GFMapTables,
    RepairGroup, RepairTables, codec_tables, crc_bytes_tables, crc_nseg,
    decode_tables, encode_map_tables, repair_tables)
from t3fs_torch.ops.torch_codec import i32, pack_bits_u32, xtimes_i32

# launches of each kernel by its wrapper (kernel launches only, never the
# plain versions); a run sets them to 0 and reads them to show which kernels
# served it
launches: dict[str, int] = {"crc_words": 0, "rs_raid6_words": 0,
                            "rs_reconstruct_words": 0, "repair_words": 0,
                            "rs_bitmatmul": 0, "crc_bytes": 0}

# consecutive segments one warp folds before its partial is written (at
# most 16, two of the tensor-core n-tiles of B1 and B6)
_RUN_SEGS = 16
# B3's limits (csrc/rs_reconstruct_words.cu); past them the wrapper runs B5
_B3_MAX_K, _B3_MAX_WANT = 32, 2


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_words(x: torch.Tensor, ndim: int, what: str,
                 dtype: torch.dtype = torch.int32) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check_cuda(x: torch.Tensor, what: str,
                tables_device: torch.device | None = None,
                aligned: bool = True) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}; the kernels take "
                         "CUDA tensors and the plain versions CPU tensors")
    if tables_device is not None and tables_device != x.device:
        raise ValueError(f"{what}: tables on {tables_device}, data on {x.device}")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"{what}: data must be 16-byte aligned")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


# --- B1: CRC words ----------------------------------------------------------

def _seg_bits_plain(rows: torch.Tensor, tables: CodecTables) -> torch.Tensor:
    """(R, 128) int32 words -> (R, 32) float32 0/1 raw segment CRC bits:
    32 bit-plane products (R, 128) @ (128, 32), as the TPU kernel runs them
    (float32 sums count at most 4096 ones, so they are exact)."""
    acc = torch.zeros(rows.shape[0], 32, dtype=torch.float32, device=rows.device)
    for bit in range(32):
        plane = ((rows >> bit) & 1).float()
        acc += plane @ tables.crc_word_weights[bit]
    return acc.remainder_(2)


def crc_seg_words_plain(rows: torch.Tensor, tables: CodecTables) -> torch.Tensor:
    """Plain version of crc_seg_words."""
    return pack_bits_u32(_seg_bits_plain(rows, tables))


def crc_seg_words(rows: torch.Tensor, tables: CodecTables) -> torch.Tensor:
    """(R, 128) int32 segment words -> (R,) int32 raw CRC of each 512-byte
    segment (zero-preserving, init 0, no final xor)."""
    _check_words(rows, 2, "crc_seg_words")
    if rows.shape[1] != SEG_WORDS:
        raise ValueError(f"crc_seg_words: rows of {SEG_WORDS} words expected, "
                         f"got {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return crc_seg_words_plain(rows, tables)
    _check_cuda(rows, "crc_seg_words", tables.crc_mma_a.device)
    out = torch.empty(rows.shape[0], dtype=torch.int32, device=rows.device)
    if rows.shape[0] == 0:
        return out
    from t3fs_torch.ops._build import check, library

    lib = library("crc_words")
    check(lib, lib.t3fs_crc_seg_words(
        rows.data_ptr(), rows.shape[0], tables.crc_mma_a.data_ptr(),
        out.data_ptr(), _stream(rows)), "crc_seg_words")
    launches["crc_words"] += 1
    return out


def crc_words_raw_plain(words: torch.Tensor, tables: CodecTables) -> torch.Tensor:
    """Plain version of crc_words_raw: segment bits, then the combine as one
    (n, S*32) @ (S*32, 32) product (counts <= S*32 < 2^24: exact)."""
    n, W = words.shape
    S = W // SEG_WORDS
    seg_bits = _seg_bits_plain(words.reshape(n * S, SEG_WORDS), tables)
    C = tables.combine_stack.transpose(1, 2).reshape(S * 32, 32)
    raw = (seg_bits.reshape(n, S * 32) @ C).remainder_(2)
    return pack_bits_u32(raw)


def crc_words_raw(words: torch.Tensor, tables: CodecTables) -> torch.Tensor:
    """(n, W) int32 words, W = tables.nseg * 128 -> (n,) int32 raw CRC of
    each chunk.  Raw CRC is zero-preserving: callers may front-pad shorter
    buffers with zero bytes and XOR affine_const(true length) themselves."""
    _check_words(words, 2, "crc_words_raw")
    n, W = words.shape
    if W != tables.nseg * SEG_WORDS:
        raise ValueError(f"crc_words_raw: tables are for {tables.nseg} segments "
                         f"({tables.nseg * SEG_WORDS} words), got {W} words")
    if words.device.type == "cpu":
        return crc_words_raw_plain(words, tables)
    _check_cuda(words, "crc_words_raw", tables.crc_mma_a.device)
    out = torch.empty(n, dtype=torch.int32, device=words.device)
    if n == 0:
        return out
    spw = pick_block(tables.nseg, _RUN_SEGS)
    partial = torch.empty(n * (tables.nseg // spw), dtype=torch.int32,
                          device=words.device)
    from t3fs_torch.ops._build import check, library

    lib = library("crc_words")
    check(lib, lib.t3fs_crc32c_words_raw(
        words.data_ptr(), n, tables.nseg, spw,
        tables.crc_mma_a.data_ptr(), tables.combine_cols.data_ptr(),
        tables.seg_shift_bytes.data_ptr(), partial.data_ptr(), out.data_ptr(),
        _stream(words)), "crc_words_raw")
    launches["crc_words"] += 1
    return out


# --- B2: RAID-6 encode words ------------------------------------------------

def rs_raid6_words_plain(words: torch.Tensor, tables: CodecTables) -> torch.Tensor:
    """Plain version of rs_raid6_words."""
    p = words[:, 0]
    q = words[:, 0]
    for s in range(1, words.shape[1]):
        p = p ^ words[:, s]
        q = xtimes_i32(q, tables.rs_poly_low) ^ words[:, s]
    return torch.stack([p, q], dim=1)


def rs_raid6_words(words: torch.Tensor, tables: CodecTables) -> torch.Tensor:
    """(n, k, W) int32 data words -> (n, 2, W) int32 RAID-6 parity words."""
    _check_words(words, 3, "rs_raid6_words")
    if not tables.rs_raid6 or words.shape[1] != tables.rs_k:
        raise ValueError(f"rs_raid6_words: tables hold {tables.rs_code_id} "
                         f"(k={tables.rs_k}), words are {tuple(words.shape)}")
    if words.device.type == "cpu":
        return rs_raid6_words_plain(words, tables)
    _check_cuda(words, "rs_raid6_words", tables.crc_mma_a.device)
    n, k, W = words.shape
    out = torch.empty(n, 2, W, dtype=torch.int32, device=words.device)
    if n == 0 or W == 0:
        return out
    from t3fs_torch.ops._build import check, library

    lib = library("rs_raid6_words")
    check(lib, lib.t3fs_rs_raid6_words(
        words.data_ptr(), out.data_ptr(), n, k, W, tables.rs_poly_low,
        _stream(words)), "rs_raid6_words")
    launches["rs_raid6_words"] += 1
    return out


# --- B3: RAID-6 decode words ------------------------------------------------

def rs_reconstruct_words_plain(words: torch.Tensor, dec: GFMapTables) -> torch.Tensor:
    """Plain version of rs_reconstruct_words: per present shard, one xtimes
    ladder up to its column's highest bit, rung b XORed into output r where
    bit b of the coefficient C[r][s] is set."""
    acc: list[torch.Tensor | None] = [None] * dec.rows
    for s in range(dec.k):
        col = [dec.coeff_rows[r][s] for r in range(dec.rows)]
        nbits = max(col).bit_length()
        t = words[:, s]
        for b in range(nbits):
            for r in range(dec.rows):
                if (col[r] >> b) & 1:
                    acc[r] = t if acc[r] is None else acc[r] ^ t
            if b + 1 < nbits:
                t = xtimes_i32(t, dec.poly_low)
    zero = torch.zeros_like(words[:, 0])
    return torch.stack([zero if a is None else a for a in acc], dim=1)


def rs_reconstruct_words(words: torch.Tensor, dec: GFMapTables) -> torch.Tensor:
    """(n, k, W) int32 present-shard words -> (n, |want|, W) int32 rebuilt
    words, by the decode coefficients in `dec`.  Past B3's limits (k > 32
    or more than 2 wanted shards) it is B5 on the byte view of the same
    words, which is the same map byte by byte."""
    _check_words(words, 3, "rs_reconstruct_words")
    if words.shape[1] != dec.k:
        raise ValueError(f"rs_reconstruct_words: tables are for k={dec.k}, "
                         f"words are {tuple(words.shape)}")
    if dec.k > _B3_MAX_K or dec.rows > _B3_MAX_WANT:
        return rs_bitmatmul(words.view(torch.uint8), dec).view(torch.int32)
    if words.device.type == "cpu":
        return rs_reconstruct_words_plain(words, dec)
    _check_cuda(words, "rs_reconstruct_words")
    n, k, W = words.shape
    out = torch.empty(n, dec.rows, W, dtype=torch.int32, device=words.device)
    if n == 0 or W == 0:
        return out
    from t3fs_torch.ops._build import check, library

    lib = library("rs_reconstruct_words")
    flat = [c for row in dec.coeff_rows for c in row]
    coeffs = (ctypes.c_uint8 * len(flat))(*flat)
    check(lib, lib.t3fs_rs_reconstruct_words(
        words.data_ptr(), out.data_ptr(), n, k, dec.rows, W, coeffs,
        dec.poly_low, _stream(words)), "rs_reconstruct_words")
    launches["rs_reconstruct_words"] += 1
    return out


# --- B4: repair words -------------------------------------------------------

def repair_words_plain(words: torch.Tensor, rep: RepairTables) -> torch.Tensor:
    """Plain version of repair_words: the XOR of the top plane's helpers,
    then for each lower plane acc = xtimes(acc) ^ XOR(plane)."""
    top = len(rep.planes) - 1
    first, *rest = rep.planes[top]
    acc = words[:, first].clone()
    for i in rest:
        acc ^= words[:, i]
    for b in range(top - 1, -1, -1):
        acc = xtimes_i32(acc, rep.poly_low)
        for i in rep.planes[b]:
            acc ^= words[:, i]
    return acc


def _repair_group_plain(words: torch.Tensor, grp: RepairGroup, poly_low: int,
                        out: torch.Tensor, accumulate: bool) -> None:
    """One group's launch in plain PyTorch: its Horner over its own planes,
    written to `out` or XORed into it."""
    acc = torch.zeros_like(out)
    for b in range(len(grp.masks) - 1, -1, -1):
        acc = xtimes_i32(acc, poly_low)
        for j in range(grp.count):
            if (grp.masks[b] >> j) & 1:
                acc ^= words[:, grp.h0 + j]
    if accumulate:
        out ^= acc
    else:
        out.copy_(acc)


def repair_words(words: torch.Tensor, rep: RepairTables) -> torch.Tensor:
    """(n, h, W) int32 helper words -> (n, W) int32 rebuilt words, by the
    scheduled repair program in `rep`: one launch per helper group, the
    first writing `out` and the others XORing into it."""
    _check_words(words, 3, "repair_words")
    if words.shape[1] != rep.num_helpers:
        raise ValueError(f"repair_words: program over {rep.num_helpers} "
                         f"helpers, words are {tuple(words.shape)}")
    n, h, W = words.shape
    out = torch.empty(n, W, dtype=torch.int32, device=words.device)
    if n == 0 or W == 0:
        return out
    cpu = words.device.type == "cpu"
    if not cpu:
        _check_cuda(words, "repair_words")
        from t3fs_torch.ops._build import check, library

        lib = library("repair_words")
    for gi, grp in enumerate(rep.groups):
        if cpu:
            _repair_group_plain(words, grp, rep.poly_low, out, gi > 0)
            continue
        masks = (ctypes.c_uint32 * len(grp.masks))(*grp.masks)
        check(lib, lib.t3fs_repair_words(
            words.data_ptr(), out.data_ptr(), n, h, grp.h0, grp.count, W, masks,
            len(grp.masks) - 1, rep.poly_low, int(gi > 0), _stream(words)),
            "repair_words")
        launches["repair_words"] += 1
    return out


# --- B5: byte-plane bit-matmul ----------------------------------------------

def _bitplanes(x: torch.Tensor, matrix_t: torch.Tensor) -> torch.Tensor:
    """(n, k, L) uint8 through a plane-major (8r, 8k) bit matrix -> (n, r,
    L) uint8, the TPU kernel's arithmetic: unpack to plane-major 0/1 planes
    (index b*k + i), one float32 product (sums <= 8k < 2^24, and 0/1
    survive TF32, so it is exact), mod 2, repack."""
    n, _k, L = x.shape
    x = x.to(torch.int32)
    planes = torch.cat([(x >> b) & 1 for b in range(8)], dim=1).float()
    bits = (torch.matmul(matrix_t, planes).to(torch.int32) & 1
            ).reshape(n, 8, matrix_t.shape[0] // 8, L)
    out = bits[:, 0]
    for b in range(1, 8):
        out = out | (bits[:, b] << b)
    return out.to(torch.uint8)


def rs_bitmatmul_plain(shards: torch.Tensor, gmap: GFMapTables) -> torch.Tensor:
    """Plain version of rs_bitmatmul: the whole bit matrix in one product."""
    return _bitplanes(shards, gmap.bitmatrix_t)


def rs_bitmatmul(shards: torch.Tensor, gmap: GFMapTables) -> torch.Tensor:
    """(n, k, L) uint8 shards -> (n, rows, L) uint8: the GF(2^8)-linear map
    in `gmap` (encode parity or a decode pattern), any L.  One launch per
    tile of gmap.tiles; a tile that does not start at input 0 XORs into the
    rows its row group's first tile wrote."""
    _check_words(shards, 3, "rs_bitmatmul", torch.uint8)
    if shards.shape[1] != gmap.k:
        raise ValueError(f"rs_bitmatmul: tables are for k={gmap.k}, shards "
                         f"are {tuple(shards.shape)}")
    n, k, L = shards.shape
    out = torch.empty(n, gmap.rows, L, dtype=torch.uint8, device=shards.device)
    if n == 0 or L == 0:
        return out
    cpu = shards.device.type == "cpu"
    if not cpu:
        _check_cuda(shards, "rs_bitmatmul", gmap.bitmatrix_t.device)
        from t3fs_torch.ops._build import check, library

        lib = library("rs_bitmatmul")
    for t in gmap.tiles:
        if cpu:
            part = _bitplanes(shards[:, t.i0:t.i0 + t.ki], t.bitmatrix_t)
            dst = out[:, t.j0:t.j0 + t.rows]
            if t.i0:
                dst ^= part
            else:
                dst.copy_(part)
            continue
        check(lib, lib.t3fs_rs_bitmatmul(
            shards.data_ptr(), out.data_ptr(), t.lut.data_ptr(), n, k, t.i0,
            t.ki, gmap.rows, t.j0, t.rows, L, int(t.i0 > 0), _stream(shards)),
            "rs_bitmatmul")
        launches["rs_bitmatmul"] += 1
    return out


# --- B6: CRC bytes ----------------------------------------------------------

def crc_bytes_runs(nseg: int) -> int:
    """B6's runs a row of `nseg` segments: ceil(nseg / 16), the first one
    ragged (nseg % 16 segments, or 16), the others 16 each."""
    return -(-nseg // _RUN_SEGS)


def _seg_bytes_bits_plain(rows: torch.Tensor, tables: CrcBytesTables
                          ) -> torch.Tensor:
    """(R, 512) uint8 -> (R, 32) float32 0/1 raw segment CRC bits, the TPU
    kernel's arithmetic: plane-major unpack (index b*512 + j), one product
    with the permuted segment matrix Lseg[perm] (sums <= 4096: exact), mod 2."""
    planes = torch.cat([(rows >> b) & 1 for b in range(8)], dim=1).float()
    return (planes @ tables.seg_matrix_pm).remainder_(2)


def crc_seg_bytes_plain(rows: torch.Tensor, tables: CrcBytesTables) -> torch.Tensor:
    """Plain version of crc_seg_bytes."""
    return pack_bits_u32(_seg_bytes_bits_plain(rows, tables))


def crc_seg_bytes(rows: torch.Tensor, tables: CrcBytesTables) -> torch.Tensor:
    """(R, 512) uint8 segment rows -> (R,) int32 raw CRC of each segment."""
    _check_words(rows, 2, "crc_seg_bytes", torch.uint8)
    if rows.shape[1] != SEG_BYTES:
        raise ValueError(f"crc_seg_bytes: rows of {SEG_BYTES} bytes expected, "
                         f"got {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return crc_seg_bytes_plain(rows, tables)
    return crc_bytes_raw(rows, tables)


def crc_bytes_raw_plain(rows: torch.Tensor, tables: CrcBytesTables) -> torch.Tensor:
    """Plain version of crc_bytes_raw: a zero front-padded copy, segment
    bits, then the combine as one (n, S*32) @ (S*32, 32) product."""
    n, L = rows.shape
    S = tables.nseg
    pad = S * SEG_BYTES - L
    padded = torch.nn.functional.pad(rows, (pad, 0)) if pad else rows
    seg_bits = _seg_bytes_bits_plain(padded.reshape(n * S, SEG_BYTES), tables)
    C = tables.combine_stack.transpose(1, 2).reshape(S * 32, 32)
    return pack_bits_u32((seg_bits.reshape(n, S * 32) @ C).remainder_(2))


def crc_bytes_raw(rows: torch.Tensor, tables: CrcBytesTables) -> torch.Tensor:
    """(n, L) uint8 rows, any L, any base address -> (n,) int32 raw CRC of
    each row front-padded with zeros to tables.nseg = crc_nseg(L) segments;
    callers XOR affine_const(L) for the CRC32C."""
    _check_words(rows, 2, "crc_bytes_raw", torch.uint8)
    n, L = rows.shape
    if tables.nseg != crc_nseg(L):
        raise ValueError(f"crc_bytes_raw: tables are for {tables.nseg} segments, "
                         f"rows of {L} bytes need {crc_nseg(L)}")
    if rows.device.type == "cpu":
        return crc_bytes_raw_plain(rows, tables)
    _check_cuda(rows, "crc_bytes_raw", tables.crc_mma_a.device, aligned=False)
    if n == 0 or L == 0:
        return torch.zeros(n, dtype=torch.int32, device=rows.device)
    out = torch.empty(n, dtype=torch.int32, device=rows.device)
    partial = torch.empty(n * crc_bytes_runs(tables.nseg), dtype=torch.int32,
                          device=rows.device)
    from t3fs_torch.ops._build import check, library

    lib = library("crc_bytes")
    check(lib, lib.t3fs_crc32c_bytes_raw(
        rows.data_ptr(), n, L, tables.nseg, tables.crc_mma_a.data_ptr(),
        tables.combine_cols.data_ptr(), tables.seg_shift_bytes.data_ptr(),
        partial.data_ptr(), out.data_ptr(), _stream(rows)), "crc_bytes_raw")
    launches["crc_bytes"] += 1
    return out


# --- assembled paths (the pallas_codec make_* twins) -----------------------

def _chunk_tables(chunk_words: int, k: int = 8, m: int = 2,
                  device: str | torch.device = "cuda") -> CodecTables:
    if chunk_words <= 0 or chunk_words % SEG_WORDS:
        raise ValueError(f"chunk_words {chunk_words} not a positive multiple "
                         f"of {SEG_WORDS}")
    return codec_tables(chunk_words // SEG_WORDS, k, m, device=device)


def make_crc_seg_words(device: str | torch.device = "cuda"):
    """(R, 128) int32 segment rows -> (R,) int32 raw segment CRCs."""
    tables = codec_tables(1, device=device)
    return lambda rows: crc_seg_words(rows, tables)


def make_crc32c_words_raw(chunk_words: int, device: str | torch.device = "cuda"):
    """(n, chunk_words) int32 words -> (n,) int32 raw CRC (no affine);
    chunk_words must be a multiple of 128 (512-byte segments)."""
    tables = _chunk_tables(chunk_words, device=device)
    return lambda words: crc_words_raw(words, tables)


def make_crc32c_words(chunk_words: int, device: str | torch.device = "cuda"):
    """(n, chunk_words) int32 words -> (n,) int32 CRC32C of whole chunks."""
    tables = _chunk_tables(chunk_words, device=device)
    affine = i32(tables.chunk_affine)
    return lambda words: crc_words_raw(words, tables) ^ affine


def make_rs_encode_words(rs: RSCode | None = None,
                         device: str | torch.device = "cuda"):
    """(n, k, W) int32 words -> (n, 2, W) int32 parity words (RAID-6 m=2)."""
    rs = rs or default_rs()
    if not rs.raid6:
        raise ValueError("the word kernel requires the RAID-6 m=2 code")
    tables = codec_tables(1, rs.k, rs.m, device=device)
    return lambda words: rs_raid6_words(words, tables)


def make_stripe_encode_step_words(chunk_words: int, k: int = 8, m: int = 2,
                                  device: str | torch.device = "cuda"):
    """The write path's stripe step: (n, k, chunk_words) int32 words ->
    parity (n, 2, chunk_words) int32 words, crcs (n, k+m) int32 (CRC32C of
    the data shards, then of the parity shards).

    B2 runs first, then B1 on the data and on the parity through reshapes of
    the same tensors, with no concat of the shards."""
    if m != 2:
        raise ValueError("the word path is RAID-6 (m=2)")
    tables = _chunk_tables(chunk_words, k, m, device)
    affine = i32(tables.chunk_affine)

    def step(words: torch.Tensor):
        n = words.shape[0]
        parity = rs_raid6_words(words, tables)
        dcrc = crc_words_raw(words.reshape(n * k, chunk_words), tables) ^ affine
        pcrc = crc_words_raw(parity.reshape(n * m, chunk_words), tables) ^ affine
        return parity, torch.cat([dcrc.reshape(n, k), pcrc.reshape(n, m)], dim=1)

    return step


def make_rs_reconstruct_words(present: tuple[int, ...], want: tuple[int, ...],
                              rs: RSCode | None = None,
                              device: str | torch.device = "cuda"):
    """(n, k, W) int32 present-shard words -> (n, |want|, W) int32 rebuilt:
    any single or double erasure of the RAID-6 m=2 code."""
    rs = rs or default_rs()
    if not rs.raid6:
        raise ValueError("the word decode requires the RAID-6 m=2 code; "
                         "use make_rs_reconstruct_bytes")
    if len(present) != rs.k:
        raise ValueError(f"present {present} must list k={rs.k} shards")
    dec = decode_tables(present, want, rs, device)
    return lambda words: rs_reconstruct_words(words, dec)


def make_stripe_decode_step_words(chunk_words: int, present: tuple[int, ...],
                                  want: tuple[int, ...], k: int = 8, m: int = 2,
                                  device: str | torch.device = "cuda"):
    """The read path's stripe step: (n, k, chunk_words) int32 present-shard
    words -> rebuilt (n, |want|, chunk_words) int32 words, crcs
    (n, k + |want|) int32 (CRC32C of the survivors in `present` order, then
    of the rebuilt shards in `want` order).

    B3 runs first, then B1 on the survivors and on the rebuilt shards
    through reshapes of the same tensors, with no concat of the shards."""
    if m != 2:
        raise ValueError("the word path is RAID-6 (m=2); use "
                         "make_rs_reconstruct_bytes")
    tables = _chunk_tables(chunk_words, k, m, device)
    rec = make_rs_reconstruct_words(present, want, default_rs(k, m), device)
    affine = i32(tables.chunk_affine)
    nwant = len(want)

    def step(words: torch.Tensor):
        n = words.shape[0]
        rebuilt = rec(words)
        scrc = crc_words_raw(words.reshape(n * k, chunk_words), tables) ^ affine
        rcrc = crc_words_raw(rebuilt.reshape(n * nwant, chunk_words), tables) ^ affine
        return rebuilt, torch.cat([scrc.reshape(n, k), rcrc.reshape(n, nwant)],
                                  dim=1)

    return step


def make_repair_subshard_words(program: RepairProgram, rs: RSCode | None = None,
                               device: str | torch.device = "cuda"):
    """(n, h, W) int32 helper sub-shard words -> (n, W) int32 rebuilt words
    by the scheduled `program` over its h helpers."""
    resolve_device(device)
    rep = repair_tables(program, rs)
    return lambda words: repair_words(words, rep)


def make_repair_step_words(sub_words: int, program: RepairProgram,
                           device: str | torch.device = "cuda"):
    """Fused sub-shard repair + CRC: (n, h, sub_words) int32 helper words ->
    rebuilt (n, sub_words) int32, crcs (n,) int32 (CRC32C of each rebuilt
    sub-shard; the client stitches them with crc32c_combine).  sub_words
    must be a multiple of 128 (512-byte segments).  B4, then B1."""
    tables = _chunk_tables(sub_words, device=device)
    rep = make_repair_subshard_words(program, device=device)
    affine = i32(tables.chunk_affine)

    def step(words: torch.Tensor):
        rebuilt = rep(words)
        return rebuilt, crc_words_raw(rebuilt, tables) ^ affine

    return step


def make_rs_reconstruct_bytes(present: tuple[int, ...], want: tuple[int, ...],
                              rs: RSCode | None = None,
                              device: str | torch.device = "cuda"):
    """(n, k, L) uint8 present shards -> (n, |want|, L) uint8: the byte-plane
    decode (B5) of any (k, m) code and any L; twin of
    make_rs_reconstruct_pallas."""
    rs = rs or default_rs()
    if len(present) != rs.k:
        raise ValueError(f"present {present} must list k={rs.k} shards")
    gmap = decode_tables(present, want, rs, device)
    return lambda shards: rs_bitmatmul(shards, gmap)


def make_rs_encode_bytes(rs: RSCode | None = None,
                         device: str | torch.device = "cuda"):
    """(n, k, L) uint8 data shards -> (n, m, L) uint8 parity: the byte-plane
    encode (B5) of any (k, m) code; twin of make_rs_encode_pallas."""
    gmap = encode_map_tables(rs or default_rs(), device)
    return lambda shards: rs_bitmatmul(shards, gmap)


def make_crc_seg_bytes(device: str | torch.device = "cuda"):
    """(R, 512) uint8 segment rows -> (R,) int32 raw segment CRCs; twin of
    make_crc_seg_pallas (which returns the 32 bits unpacked)."""
    tables = crc_bytes_tables(1, device)
    return lambda rows: crc_seg_bytes(rows, tables)


def make_crc32c_raw_fast(padded_len: int, device: str | torch.device = "cuda"):
    """(n, padded_len) uint8 -> (n,) int32 raw CRC (no affine); twin of
    make_crc32c_raw_fast.  padded_len must be a multiple of 512."""
    if padded_len <= 0 or padded_len % SEG_BYTES:
        raise ValueError(f"padded_len {padded_len} not a positive multiple of "
                         f"{SEG_BYTES}")
    tables = crc_bytes_tables(padded_len // SEG_BYTES, device)
    return lambda rows: crc_bytes_raw(rows, tables)


def make_crc32c_bytes(chunk_len: int, device: str | torch.device = "cuda"):
    """(n, chunk_len) uint8 -> (n,) int32 CRC32C of each row, any length:
    raw CRC of the front-padded row, XOR the true length's affine constant.
    The card's counterpart of jax_codec.make_crc32c_batch."""
    tables = crc_bytes_tables(crc_nseg(chunk_len), device)
    affine = i32(default_matrices().affine_const(chunk_len))
    return lambda rows: crc_bytes_raw(rows, tables) ^ affine


def make_crc32c_rows(chunk_len: int, device: str | torch.device = "cuda"):
    """(n, chunk_len) uint8 rows -> (n,) int32 CRC32C: B1 on the rows' word
    view where they are whole segments, else B6."""
    if chunk_len % SEG_BYTES or chunk_len == 0:
        return make_crc32c_bytes(chunk_len, device)
    crc = make_crc32c_words(chunk_len // 4, device)
    return lambda rows: crc(rows.view(torch.int32))


def _encode_crc_step(encode, chunk_len: int, k: int, m: int,
                     device: str | torch.device):
    """`encode` ((n, k, L) uint8 -> (n, m, L) uint8 parity), then B6 on the
    data and on the parity through reshapes of the same tensors."""
    crc = make_crc32c_bytes(chunk_len, device)

    def step(stripes: torch.Tensor):
        n = stripes.shape[0]
        parity = encode(stripes)
        dcrc = crc(stripes.reshape(n * k, chunk_len)).reshape(n, k)
        pcrc = crc(parity.reshape(n * m, chunk_len)).reshape(n, m)
        return parity, torch.cat([dcrc, pcrc], dim=1)

    return step


def make_stripe_encode_step_fast(chunk_len: int, k: int = 8, m: int = 2,
                                 device: str | torch.device = "cuda"):
    """The byte-path stripe step: (n, k, chunk_len) uint8 -> parity (n, m,
    chunk_len) uint8, crcs (n, k+m) int32 (data shards, then parity).  B5
    encode, then B6 on the data and on the parity with no concat; twin of
    make_stripe_encode_step_fast, for any chunk_len."""
    return _encode_crc_step(make_rs_encode_bytes(default_rs(k, m), device),
                            chunk_len, k, m, device)


def make_stripe_encode_step_bytes(chunk_len: int, k: int = 8, m: int = 2,
                                  device: str | torch.device = "cuda"):
    """The write step of the chunk lengths the word step does not take: B2
    on the int32 view where the code is RAID-6 and chunk_len % 4 == 0, else
    B5; then B6 on the data and on the parity."""
    rs = default_rs(k, m)
    if not (rs.raid6 and chunk_len % 4 == 0):
        return make_stripe_encode_step_fast(chunk_len, k, m, device)
    enc = make_rs_encode_words(rs, device)

    def encode(stripes: torch.Tensor) -> torch.Tensor:
        return enc(stripes.view(torch.int32)).view(torch.uint8)

    return _encode_crc_step(encode, chunk_len, k, m, device)


def make_stripe_decode_step_bytes(chunk_len: int, present: tuple[int, ...],
                                  want: tuple[int, ...], k: int = 8, m: int = 2,
                                  device: str | torch.device = "cuda"):
    """The byte-path read step: (n, k, chunk_len) uint8 present shards ->
    rebuilt (n, |want|, chunk_len) uint8, crcs (n, k + |want|) int32
    (survivors in `present` order, then the rebuilt shards in `want`
    order).  B5 decode, then B6 on the survivors and the rebuilt shards;
    the card's counterpart of ECCodec's XLA-fused decode."""
    rec = make_rs_reconstruct_bytes(present, want, default_rs(k, m), device)
    crc = make_crc32c_bytes(chunk_len, device)
    nwant = len(want)

    def step(shards: torch.Tensor):
        n = shards.shape[0]
        rebuilt = rec(shards)
        scrc = crc(shards.reshape(n * k, chunk_len)).reshape(n, k)
        rcrc = crc(rebuilt.reshape(n * nwant, chunk_len)).reshape(n, nwant)
        return rebuilt, torch.cat([scrc, rcrc], dim=1)

    return step


def repair_bytes(rows: torch.Tensor, rep: RepairTables) -> torch.Tensor:
    """(n, h, L) uint8 contiguous helper rows, any L -> (n, L) uint8: B4 on
    the rows zero-padded to whole words, cut back to L."""
    L = rows.shape[-1]
    pad = (-L) % 4
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    out = repair_words(rows.view(torch.int32), rep).view(torch.uint8)
    return out[:, :L].contiguous() if pad else out


def make_repair_step_bytes(chunk_len: int, program: RepairProgram,
                           device: str | torch.device = "cuda"):
    """Repair of rows whose length the fused word step does not take: (n,
    h, chunk_len) uint8 helper rows -> rebuilt (n, chunk_len) uint8, crcs
    (n,) int32.  B4 on whole words (repair_bytes), then B6."""
    resolve_device(device)
    rep = repair_tables(program)
    crc = make_crc32c_bytes(chunk_len, device)

    def step(rows: torch.Tensor):
        out = repair_bytes(rows, rep)
        return out, crc(out)

    return step
