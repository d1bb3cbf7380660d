"""The write-path kernels' plain versions (t3fs_torch.ops.cuda_codec on CPU
tensors) against the JAX package's Pallas kernels in interpret mode, the
codec tables against the JAX package's arrays, and a numpy model of the
CUDA CRC kernel: its tensor-core product by PTX's fragment layout, its
epilogue and its chunk fold (the kernel itself runs only on a GPU; the
`cuda` tests hold it against the plain versions there).

Shapes follow tests/test_pallas_codec.py.  Every comparison is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t3fs.ops import pallas_codec as pc
from t3fs.ops.crc32c import crc32c_ref, default_matrices as ref_matrices
from t3fs.ops.jax_codec import pack_bits_u32 as jax_pack_u32
from t3fs.ops.rs import default_rs as ref_default_rs
from t3fs_torch.benchmarks import b1_probe
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.blocks import pick_block
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.tables import build_codec_tables, codec_tables, load_codec_tables
from torch_crc_model import (
    a_fragments as _a_fragments, fold_run as _fold_run, k_word as _k_word,
    mma_b1 as _mma_b1, unit_crcs as _emulate_unit_crcs)

rng = np.random.default_rng(17)


def _words(byts: np.ndarray) -> np.ndarray:
    """uint8 (..., L) -> little-endian uint32 (..., L//4)."""
    return np.ascontiguousarray(byts).view(np.uint32)


def _t(words_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words_u32.view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_crc_seg_words_matches_pallas():
    rows = rng.integers(0, 2**32, (16, 128), dtype=np.uint32)
    ref = pc.make_crc_seg_words_pallas(block_r=8, interpret=True)(jnp.asarray(rows))
    got = cc.make_crc_seg_words(device="cpu")(_t(rows))
    assert np.array_equal(_u32(got), np.asarray(jax_pack_u32(ref)))


@pytest.mark.parametrize("L", [512, 2048, 5120])
def test_crc32c_words_raw_and_crc_match_pallas(L):
    rows = rng.integers(0, 256, (3, L), dtype=np.uint8)
    w = _words(rows)
    ref_raw = np.asarray(pc.make_crc32c_words_raw(L // 4, block_r=8, interpret=True)(
        jnp.asarray(w)))
    got_raw = cc.make_crc32c_words_raw(L // 4, device="cpu")(_t(w))
    assert np.array_equal(_u32(got_raw), ref_raw)
    got = cc.make_crc32c_words(L // 4, device="cpu")(_t(w))
    assert [int(c) for c in _u32(got)] == [crc32c_ref(r.tobytes()) for r in rows]


@pytest.mark.parametrize("block_w,L", [(512, 2048), (4096, 16384)])
def test_rs_encode_words_matches_pallas(block_w, L):
    data = rng.integers(0, 256, (2, 8, L), dtype=np.uint8)
    ref = np.asarray(pc.make_rs_encode_words_pallas(block_w=block_w, interpret=True)(
        jnp.asarray(_words(data))))
    got = cc.make_rs_encode_words(device="cpu")(_t(_words(data)))
    assert np.array_equal(_u32(got), ref)
    for i in range(2):
        assert np.array_equal(_u32(got[i]).view(np.uint8).reshape(2, L),
                              default_rs().encode_ref(data[i]))


def test_stripe_encode_step_words_matches_pallas():
    L = 2048
    stripes = rng.integers(0, 256, (2, 8, L), dtype=np.uint8)
    rpar, rcrc = pc.make_stripe_encode_step_words(L // 4, interpret=True)(
        jnp.asarray(_words(stripes)))
    parity, crcs = cc.make_stripe_encode_step_words(L // 4, device="cpu")(
        _t(_words(stripes)))
    assert np.array_equal(_u32(parity), np.asarray(rpar))
    assert np.array_equal(_u32(crcs), np.asarray(rcrc))
    assert crcs.shape == (2, 10)


def _jax_arrays(nseg: int, k: int = 8, m: int = 2) -> dict:
    """The codec constants as the JAX package builds them."""
    mats, rs = ref_matrices(), ref_default_rs(k, m)
    return {
        "crc_word_weights": pc._crc_word_weights(),
        "combine_stack": mats.combine_stack(nseg, pc.WORD_SEG_BYTES),
        "seg_shift": mats.shift_matrix(pc.WORD_SEG_BYTES),
        "chunk_affine": np.array(mats.affine_const(nseg * pc.WORD_SEG_BYTES),
                                 dtype=np.uint32),
        "rs_G": rs.G,
        "rs_parity_bitmatrix": rs.parity_bitmatrix,
        "rs_code_id": np.array(rs.code_id),
        "rs_poly": np.array(rs.gf.poly, dtype=np.int64),
    }


@pytest.mark.parametrize("nseg", [1, 4])
def test_load_codec_tables_from_jax_arrays(nseg):
    """The port's own constants equal the JAX package's, and tables loaded
    from either give identical outputs."""
    ref_arrays, own = _jax_arrays(nseg), build_codec_tables(nseg)
    assert ref_arrays.keys() == own.keys()
    for key in own:
        assert np.array_equal(np.asarray(ref_arrays[key]), np.asarray(own[key])), key
    a = load_codec_tables(ref_arrays, device="cpu")
    b = load_codec_tables(own, device="cpu")
    for f in ("crc_word_weights", "crc_mma_a", "combine_stack",
              "combine_cols", "seg_shift_bytes", "rs_parity_bitmatrix"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.chunk_affine, a.rs_poly_low, a.rs_code_id, a.rs_raid6) == \
        (b.chunk_affine, b.rs_poly_low, "raid6-g2-11d", True)
    words = _t(rng.integers(0, 2**32, (3, nseg * 128), dtype=np.uint32))
    assert torch.equal(cc.crc_words_raw(words, a), cc.crc_words_raw(words, b))
    data = _t(rng.integers(0, 2**32, (2, 8, 64), dtype=np.uint32))
    assert torch.equal(cc.rs_raid6_words(data, a), cc.rs_raid6_words(data, b))


# --- numpy model of crc_words.cu (B1 as a binary tensor-core product) -------

def _units(words: np.ndarray, unit_segs: int) -> tuple[np.ndarray, list[int]]:
    """(R, 128) segments -> (U, 16, 128) units of unit_segs, zero-padded."""
    R = len(words)
    U = -(-R // unit_segs)
    units = np.zeros((U, 16, 128), dtype=np.uint32)
    ncols = []
    for u in range(U):
        part = words[u * unit_segs:(u + 1) * unit_segs]
        units[u, :len(part)] = part
        ncols.append(len(part))
    return units, ncols


def _emulate_crc_seg_words(rows: np.ndarray, tables) -> list[int]:
    """t3fs_crc_seg_words: units of 16 rows, the last one ragged."""
    units, ncols = _units(rows, 16)
    crcs = _emulate_unit_crcs(_a_fragments(tables), units)
    return [int(c) for u, n in enumerate(ncols) for c in crcs[u, :n]]


def _emulate_crc_kernel(words: np.ndarray, tables, spw: int) -> list[int]:
    """t3fs_crc32c_words_raw: units are runs of spw segments; the Horner
    fold acc = Mb^512 . acc ^ seg with Mb^512 as four byte lookups, then
    P[last] of the run; the runs of a chunk XOR together."""
    S = tables.nseg
    units, _ = _units(words.reshape(-1, 128), spw)
    crcs = _emulate_unit_crcs(_a_fragments(tables), units)
    out = []
    for chunk in range(len(words)):
        total = 0
        for r in range(S // spw):
            total ^= _fold_run(tables, crcs[chunk * (S // spw) + r], spw,
                               r * spw + spw - 1)
        out.append(total)
    return out


def test_mma_model_matches_probe_layout():
    """The model's mma equals b1_probe's host reading of PTX's layout, the
    one the card confirmed, on random registers."""
    for _ in range(4):
        a = rng.integers(0, 2**32, (32, 4), dtype=np.uint32)
        b = rng.integers(0, 2**32, (32, 2), dtype=np.uint32)
        assert np.array_equal(_mma_b1(a, b), b1_probe._frag_host(a, b))


def test_crc_mma_matrix_and_k_order():
    """Operand A is the JAX package's CRC weights packed row-wise, and the
    k-steps pair every segment word with its row word exactly once."""
    A = codec_tables(1, device="cpu").crc_mma_a.numpy().view(np.uint32).reshape(32, 128)
    W = pc._crc_word_weights()                                   # (32 bits, 128, 32)
    bits = (A.T[None] >> np.arange(32, dtype=np.uint32)[:, None, None]) & 1
    assert np.array_equal(bits.astype(np.float32), W)
    assert sorted(_k_word(ks, t) + h for ks in range(16) for t in range(4)
                  for h in range(2)) == list(range(128))


def test_crc_seg_kernel_model_matches_pallas():
    """The kernel model on random segments (a ragged last unit) equals the
    JAX Pallas kernel in interpret mode."""
    rows = rng.integers(0, 2**32, (40, 128), dtype=np.uint32)
    ref = pc.make_crc_seg_words_pallas(block_r=8, interpret=True)(jnp.asarray(rows))
    want = [int(c) for c in np.asarray(jax_pack_u32(ref)).view(np.uint32)]
    assert _emulate_crc_seg_words(rows, codec_tables(1, device="cpu")) == want


def test_crc_seg_kernel_model_on_every_one_hot_segment():
    """All 4096 one-hot segments: the model gives each bit's CRC column."""
    rows = np.zeros((4096, 128), dtype=np.uint32)
    rows[np.arange(4096), np.arange(4096) // 32] = np.uint32(1) << (np.arange(4096) % 32
                                                                  ).astype(np.uint32)
    tables = codec_tables(1, device="cpu")
    want = [int(c) for c in _u32(cc.crc_seg_words_plain(_t(rows), tables))]
    assert _emulate_crc_seg_words(rows, tables) == want


@pytest.mark.parametrize("nseg,spw", [(4, 1), (4, 2), (4, pick_block(4, 16)), (6, 3),
                                      (1, 1), (6, 6), (64, 8), (64, pick_block(64, 16))])
def test_crc_kernel_table_layout_and_fold(nseg, spw):
    """The CUDA kernel's tables and its fold, emulated on the host, give the
    plain version's raw CRCs for every run length it may pick."""
    tables = codec_tables(nseg, device="cpu")
    words = rng.integers(0, 2**32, (2, nseg * 128), dtype=np.uint32)
    want = [int(c) for c in _u32(cc.crc_words_raw(_t(words), tables))]
    assert _emulate_crc_kernel(words, tables, spw) == want


def test_wrappers_reject_bad_input():
    tables = codec_tables(1, device="cpu")
    good = torch.zeros(2, 128, dtype=torch.int32)
    with pytest.raises(TypeError):
        cc.crc_words_raw(good.to(torch.int64), tables)
    with pytest.raises(ValueError):
        cc.crc_words_raw(torch.zeros(2, 256, dtype=torch.int32), tables)
    with pytest.raises(ValueError):
        cc.crc_seg_words(torch.zeros(4, 256, dtype=torch.int32)[:, ::2], tables)
    with pytest.raises(ValueError):
        cc.rs_raid6_words(torch.zeros(2, 4, 8, dtype=torch.int32), tables)
    with pytest.raises(ValueError):
        cc.make_crc32c_words_raw(100, device="cpu")
    with pytest.raises(ValueError):
        cc.make_rs_encode_words(default_rs(4, 3), device="cpu")


def test_plain_versions_never_count_launches():
    cc.reset_launches()
    tables = codec_tables(1, device="cpu")
    cc.crc_words_raw(torch.zeros(1, 128, dtype=torch.int32), tables)
    cc.rs_raid6_words(torch.zeros(1, 8, 4, dtype=torch.int32), tables)
    assert set(cc.launches) >= {"crc_words", "rs_raid6_words"}
    assert not any(cc.launches.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu(cuda_device):
    """On the card: B1 and B2 against their plain versions (bit-exact)."""
    tables = codec_tables(8, device=cuda_device)
    words = torch.from_numpy(rng.integers(0, 2**32, (5, 8 * 128), dtype=np.uint32)
                             .view(np.int32)).to(cuda_device)
    cc.reset_launches()
    assert torch.equal(cc.crc_words_raw(words, tables),
                       cc.crc_words_raw_plain(words, tables))
    rows = words.reshape(-1, 128)
    assert torch.equal(cc.crc_seg_words(rows, tables),
                       cc.crc_seg_words_plain(rows, tables))
    data = words[:4].reshape(4, 8, 128)
    assert torch.equal(cc.rs_raid6_words(data, tables),
                       cc.rs_raid6_words_plain(data, tables))
    odd = data[:, :, :127].contiguous()           # scalar (non-vector) path
    assert torch.equal(cc.rs_raid6_words(odd, tables),
                       cc.rs_raid6_words_plain(odd, tables))
    torch.cuda.synchronize()
    assert (cc.launches["crc_words"], cc.launches["rs_raid6_words"]) == (2, 2)
