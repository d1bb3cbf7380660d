"""The write path's word-packed kernels: twin of the main-path part of
t3fs/ops/pallas_codec.py (l.248-451).

Two hand-written CUDA kernels (t3fs_torch/csrc/), each with its plain
PyTorch version beside it and a launch counter:

  crc_words       B1: raw CRC32C of 512-byte segments (128 words) and the
                  chunk combine -- replaces _crc_words_kernel (pallas_codec.py:310)
                  and the combine matmul of make_crc32c_words_raw
  rs_raid6_words  B2: RAID-6 P/Q parity -- replaces _rs_raid6_words_kernel
                  (pallas_codec.py:261)

Data contract (the reference's): shards are the little-endian uint32 view of
the byte shards (byte j is byte j % 4 of word j // 4), carried as int32
tensors with the same bits, so numpy's `arr.view(np.int32)` goes in and
`.numpy().view(np.uint32)` comes out.  CRCs come back the same way.

A wrapper chooses by the tensor it is given: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (or raises).  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from t3fs_torch.ops.blocks import pick_block
from t3fs_torch.ops.rs import RSCode, default_rs
from t3fs_torch.ops.tables import SEG_WORDS, CodecTables, codec_tables
from t3fs_torch.ops.torch_codec import i32, pack_bits_u32, xtimes_i32

# launches of each kernel by its wrapper (kernel launches only, never the
# plain versions); a run sets them to 0 and reads them to show which kernels
# served it
launches: dict[str, int] = {"crc_words": 0, "rs_raid6_words": 0}

# consecutive segments one warp folds before its partial is written
_RUN_SEGS = 16


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_words(x: torch.Tensor, ndim: int, what: str) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check_cuda(x: torch.Tensor, tables: CodecTables, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}; the kernels take "
                         "CUDA tensors and the plain versions CPU tensors")
    if tables.crc_nibble_table.device != x.device:
        raise ValueError(f"{what}: tables on {tables.device}, words on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: words must be 16-byte aligned")


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
    _check_cuda(rows, tables, "crc_seg_words")
    out = torch.empty(rows.shape[0], dtype=torch.int32, device=rows.device)
    if rows.shape[0] == 0:
        return out
    from t3fs_torch.ops._build import check, library

    lib = library("crc_words")
    check(lib, lib.t3fs_crc_seg_words(
        rows.data_ptr(), rows.shape[0], tables.crc_nibble_table.data_ptr(),
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
    _check_cuda(words, tables, "crc_words_raw")
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
        tables.crc_nibble_table.data_ptr(), tables.combine_cols.data_ptr(),
        tables.seg_shift_cols.data_ptr(), partial.data_ptr(), out.data_ptr(),
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
    _check_cuda(words, tables, "rs_raid6_words")
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
