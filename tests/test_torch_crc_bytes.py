"""The byte-path CRC (B6) and the byte-path stripe steps on the port:
t3fs_torch.ops.cuda_codec on CPU tensors (the kernels' plain versions)
against the JAX package's make_crc_seg_pallas / make_crc32c_raw_fast /
make_stripe_encode_step_fast (Pallas in interpret mode), its XLA
make_crc32c_batch and decode, and crc32c_ref; B6's tables against the JAX
package's arrays; and a lane-level numpy model of the CUDA kernel's own
arithmetic (segments counted from each row's end, the unaligned loads and
their assembly, the zero mask of the front pad, the tensor-core product,
the ragged first run and the fold).

Shapes follow tests/test_pallas_codec.py.  Every comparison is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t3fs.ops import jax_codec
from t3fs.ops import pallas_codec as pc
from t3fs.ops.crc32c import crc32c_ref, default_matrices as ref_matrices
from t3fs.ops.rs import default_rs as ref_default_rs
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.repair_program import eval_program_np, single_row_program
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.tables import (
    build_crc_bytes_arrays, codec_tables, crc_bytes_tables, crc_nseg,
    load_crc_bytes_tables)
from torch_crc_model import G, LANE, T, a_fragments, fold_run, unit_crcs

rng = np.random.default_rng(41)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bytes(n: int, L: int) -> np.ndarray:
    return rng.integers(0, 256, (n, L), dtype=np.uint8)


def test_crc_seg_bytes_matches_pallas():
    rows = _bytes(16, 512)
    ref = pc.make_crc_seg_pallas(block_r=8, interpret=True)(jnp.asarray(rows))
    want = np.asarray(jax_codec.pack_bits_u32(ref))
    tables = crc_bytes_tables(1, device="cpu")
    assert np.array_equal(_u32(cc.make_crc_seg_bytes(device="cpu")(torch.from_numpy(rows))),
                          want)
    assert np.array_equal(_u32(cc.crc_seg_bytes_plain(torch.from_numpy(rows), tables)),
                          want)


def test_crc32c_raw_fast_matches_pallas():
    L = 1024
    rows = _bytes(3, L)
    ref = pc.make_crc32c_raw_fast(L, seg_bytes=512, block_r=4, interpret=True)(
        jnp.asarray(rows))
    got = cc.make_crc32c_raw_fast(L, device="cpu")(torch.from_numpy(rows))
    assert np.array_equal(_u32(got), np.asarray(jax_codec.pack_bits_u32(ref)))
    affine = ref_matrices().affine_const(L)
    assert [int(c) ^ affine for c in _u32(got)] == [crc32c_ref(r.tobytes()) for r in rows]


@pytest.mark.parametrize("L", [1, 9, 511, 513, 1000, 4093])
def test_crc32c_bytes_matches_xla_batch_and_oracle(L):
    rows = _bytes(3, L)
    got = _u32(cc.make_crc32c_bytes(L, device="cpu")(torch.from_numpy(rows)))
    want = np.asarray(jax_codec.make_crc32c_batch(L)(jnp.asarray(rows)))
    assert np.array_equal(got, want)
    assert [int(c) for c in got] == [crc32c_ref(r.tobytes()) for r in rows]


@pytest.mark.parametrize("L", [9, 1000, 2048])
def test_crc32c_rows_takes_words_or_bytes(L):
    """make_crc32c_rows: B1 on whole segments, B6 otherwise; the same CRCs."""
    rows = _bytes(4, L)
    got = _u32(cc.make_crc32c_rows(L, device="cpu")(torch.from_numpy(rows)))
    assert [int(c) for c in got] == [crc32c_ref(r.tobytes()) for r in rows]


@pytest.mark.parametrize("k,m", [(8, 2), (6, 3)])
def test_stripe_encode_step_fast_matches_pallas(k, m):
    L = 1024
    stripes = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    rpar, rcrc = pc.make_stripe_encode_step_fast(L, k, m, interpret=True)(
        jnp.asarray(stripes))
    parity, crcs = cc.make_stripe_encode_step_fast(L, k, m, device="cpu")(
        torch.from_numpy(stripes))
    assert np.array_equal(parity.numpy(), np.asarray(rpar))
    assert np.array_equal(_u32(crcs), np.asarray(rcrc))
    assert crcs.shape == (2, k + m)


@pytest.mark.parametrize("k,m,L", [(8, 2, 1000), (8, 2, 1002), (6, 3, 777)])
def test_stripe_encode_step_bytes_matches_xla(k, m, L):
    """The codec's byte write step (B2 on words for RAID-6 at L % 4 == 0,
    else B5; then B6) against the reference's XLA encode and batch CRC."""
    stripes = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    parity, crcs = cc.make_stripe_encode_step_bytes(L, k, m, device="cpu")(
        torch.from_numpy(stripes))
    rpar = np.asarray(jax_codec.make_rs_encode(ref_default_rs(k, m))(jnp.asarray(stripes)))
    crcf = jax_codec.make_crc32c_batch(L)
    rcrc = np.concatenate([np.asarray(crcf(jnp.asarray(stripes.reshape(-1, L)))).reshape(2, k),
                           np.asarray(crcf(jnp.asarray(rpar.reshape(-1, L)))).reshape(2, m)],
                          axis=1)
    assert np.array_equal(parity.numpy(), rpar)
    assert np.array_equal(_u32(crcs), rcrc)


@pytest.mark.parametrize("k,m,L,lost", [(6, 3, 1024, (1, 4, 7)), (8, 2, 1000, (0, 9)),
                                        (4, 3, 513, (2,))])
def test_stripe_decode_step_bytes_matches_xla(k, m, L, lost):
    """B5 decode then B6 against the reference ECCodec's XLA-fused decode
    (jax_codec.make_rs_reconstruct + make_crc32c_batch)."""
    rs = ref_default_rs(k, m)
    data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    full = np.stack([np.concatenate([d, rs.encode_ref(d)]) for d in data])
    present = tuple(s for s in range(k + m) if s not in lost)[:k]
    rows = np.ascontiguousarray(full[:, list(present)])
    rebuilt, crcs = cc.make_stripe_decode_step_bytes(L, present, lost, k, m, device="cpu")(
        torch.from_numpy(rows))
    want = np.asarray(jax_codec.make_rs_reconstruct(present, lost, rs)(jnp.asarray(rows)))
    assert np.array_equal(rebuilt.numpy(), want)
    assert np.array_equal(rebuilt.numpy(), full[:, list(lost)])
    crcf = jax_codec.make_crc32c_batch(L)
    rcrc = np.asarray(crcf(jnp.asarray(full[:, list(present + lost)].reshape(-1, L))))
    assert np.array_equal(_u32(crcs), rcrc.reshape(2, k + len(lost)))


@pytest.mark.parametrize("L", [1000, 1001])
def test_repair_step_bytes_matches_oracle(L):
    """B4 on the word-padded rows, cut back, then B6."""
    rs = default_rs(8, 2)
    present = [s for s in range(10) if s != 9][:8]
    prog = single_row_program(rs, present, 9)
    helpers = rng.integers(0, 256, (3, prog.num_helpers, L), dtype=np.uint8)
    out, crcs = cc.make_repair_step_bytes(L, prog, device="cpu")(torch.from_numpy(helpers))
    for i in range(3):
        want = eval_program_np(prog, helpers[i], rs)
        assert np.array_equal(out[i].numpy(), want)
        assert int(_u32(crcs)[i]) == crc32c_ref(want.tobytes())


def _jax_crc_bytes_arrays(nseg: int) -> dict:
    mats = ref_matrices()
    return {"segment_matrix": mats.segment_matrix(512),
            "combine_stack": mats.combine_stack(nseg, 512),
            "seg_shift": mats.shift_matrix(512)}


@pytest.mark.parametrize("nseg", [1, 3])
def test_load_crc_bytes_tables_from_jax_arrays(nseg):
    """The port's own B6 constants equal the JAX package's, tables loaded
    from either give identical outputs, and the kernel's operand A and
    Mb^512 byte tables are B1's (a segment's bytes are its words' bytes)."""
    ref_arrays, own = _jax_crc_bytes_arrays(nseg), build_crc_bytes_arrays(nseg)
    assert ref_arrays.keys() == own.keys()
    for key in own:
        assert np.array_equal(ref_arrays[key], own[key]), key
    a = load_crc_bytes_tables(ref_arrays, device="cpu")
    b = load_crc_bytes_tables(own, device="cpu")
    for f in ("seg_matrix_pm", "combine_stack", "crc_mma_a", "combine_cols",
              "seg_shift_bytes"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    perm = pc._plane_major_perm(512)
    assert np.array_equal(a.seg_matrix_pm.numpy(),
                          ref_arrays["segment_matrix"][perm].astype(np.float32))
    words = codec_tables(nseg, device="cpu")
    assert torch.equal(a.crc_mma_a, words.crc_mma_a)
    assert torch.equal(a.seg_shift_bytes, words.seg_shift_bytes)
    assert torch.equal(a.combine_cols, words.combine_cols)
    # A from the JAX package's weights: bit i of word w of row r is the
    # weight of segment bit 32w + i in CRC bit r
    A = a.crc_mma_a.numpy().view(np.uint32).reshape(32, 128)
    bits = (A.T[None] >> np.arange(32, dtype=np.uint32)[:, None, None]) & 1
    assert np.array_equal(bits.astype(np.float32), pc._crc_word_weights())
    rows = torch.from_numpy(_bytes(3, nseg * 512 - 7))
    assert torch.equal(cc.crc_bytes_raw(rows, a), cc.crc_bytes_raw(rows, b))


# --- lane-level model of crc_bytes.cu ---------------------------------------

def _byte_shift(lo: np.ndarray, hi: np.ndarray, sh: int) -> np.ndarray:
    """byte_shift: bytes sh..sh+15 of lo:hi ((..., 4) u32 each), as words
    sh // 4 .. +4 funnel-shifted right by 8 (sh % 4) bits."""
    w = np.concatenate([lo, hi], -1).astype(np.uint64)
    wo, b = sh >> 2, np.uint64(8 * (sh & 3))
    return ((w[..., wo:wo + 4] | (w[..., wo + 1:wo + 5] << np.uint64(32))) >> b
            ).astype(np.uint32)


def _in_row(o: np.ndarray) -> np.ndarray:
    """in_row: the bytes of the word at row offset o that lie in the row."""
    part = (np.uint64(0xFFFFFFFF) << (8 * np.clip(-o, 0, 3)).astype(np.uint64))
    return np.where(o >= 0, 0xFFFFFFFF, np.where(o <= -4, 0, part)).astype(np.uint32)


def _load_unit(buf: np.ndarray, row0: int, L: int, off0: int,
               ncols: int) -> np.ndarray:
    """load_unit over a flat buffer whose row starts at index row0 (index 0
    is 16-byte aligned): each lane's aligned uint4 loads (checked to hold a
    byte of the row), the 33rd uint4 of lanes t = 0, the shuffle from lane
    t + 1, the byte shift, the front-pad mask.  -> (2, 8, 32, 4) u32 x[nt][q]
    as the lanes hold them."""
    mis = row0 % 16
    sh = (mis + off0) % 16

    def ld(p: int) -> np.ndarray:
        assert (row0 + p) % 16 == 0 and -16 < p < L, (row0, p, L)
        return buf[row0 + p:row0 + p + 16].view(np.uint32)

    x = np.zeros((2, 8, 32, 4), dtype=np.uint32)
    last = np.zeros((2, 32, 4), dtype=np.uint32)
    for nt in range(2):
        for lane in range(32):
            col, t = 8 * nt + G[lane], T[lane]
            if col >= ncols:
                continue
            p0 = ((mis + off0 + col * 512) & ~15) - mis
            for q in range(8):
                p = p0 + 16 * (4 * q + t)
                if p > -16:
                    x[nt, q, lane] = ld(p)
            if sh and t == 0:
                last[nt, lane] = ld(p0 + 512)
    if sh:
        src = (LANE & ~3) | ((T + 1) & 3)
        for nt in range(2):
            for q in range(8):
                nxt = x[nt, q + 1] if q < 7 else last[nt]
                give = np.where((T != 0)[:, None], x[nt, q], nxt)
                x[nt, q] = _byte_shift(x[nt, q], give[src], sh)
    if off0 < 0:
        for nt in range(2):
            for q in range(8):
                o = off0 + (8 * nt + G) * 512 + 16 * (4 * q + T)
                x[nt, q] &= _in_row(o[:, None] + np.arange(0, 16, 4))
    return x


def _emulate_crc_bytes_kernel(buf: np.ndarray, base: int, n: int, L: int,
                              tables) -> list[int]:
    """crc_bytes.cu, lane by lane, over n rows of L bytes starting at
    buf[base]: each row is ceil(S / 16) runs, the first one ragged; a run's
    unit is loaded by _load_unit, multiplied by the tensor-core model, folded
    by Horner and P[its last segment]; a row's partials XOR together."""
    S = tables.nseg
    runs = cc.crc_bytes_runs(S)
    units, meta = [], []
    for r in range(n):
        for j in range(runs):
            s_end = S - 16 * (runs - 1 - j)
            s0 = max(0, s_end - 16)
            x = _load_unit(buf, base + r * L, L, L - (S - s0) * 512, s_end - s0)
            segs = np.zeros((16, 8, 4, 4), dtype=np.uint32)    # [col, q, t, word]
            for nt in range(2):
                segs[8 * nt + G, :, T] = x[nt].transpose(1, 0, 2)
            units.append(segs.reshape(16, 128))
            meta.append((r, s_end - s0, s_end - 1))
    crcs = unit_crcs(a_fragments(tables), np.stack(units))
    out = [0] * n
    for u, (r, ncols, s_last) in enumerate(meta):
        out[r] ^= fold_run(tables, crcs[u], ncols, s_last)
    return out


_model_rows: dict[int, tuple[np.ndarray, list[int]]] = {}


def _model_reference(L: int, n: int) -> tuple[np.ndarray, list[int]]:
    """n random rows of L bytes (one draw per L) and their raw CRCs by the
    JAX package's make_crc32c_raw_fast (Pallas in interpret mode) on the
    zero front-padded rows, checked against crc32c_ref."""
    if L not in _model_rows:
        rows = np.random.default_rng(L).integers(0, 256, (n, L), dtype=np.uint8)
        S = crc_nseg(L)
        padded = np.zeros((n, S * 512), dtype=np.uint8)
        padded[:, S * 512 - L:] = rows
        ref = pc.make_crc32c_raw_fast(S * 512, seg_bytes=512, block_r=256,
                                      interpret=True)(jnp.asarray(padded))
        raw = [int(c) for c in np.asarray(jax_codec.pack_bits_u32(ref)).view(np.uint32)]
        affine = ref_matrices().affine_const(L)
        assert [c ^ affine for c in raw] == [crc32c_ref(r.tobytes()) for r in rows]
        _model_rows[L] = (rows, raw)
    return _model_rows[L]


@pytest.mark.parametrize("base", [0, 1, 3, 5, 16])
@pytest.mark.parametrize("L", [1, 37, 511, 512, 513, 1000, 1531, 8192 - 5, 16 * 512 + 3])
def test_crc_bytes_kernel_emulation(L, base):
    """The CUDA kernel's loads, product, ragged first run and fold, modelled
    lane by lane over two rows back to back from byte `base` (so the rows
    start at two alignments), give the JAX Pallas kernel's raw CRCs."""
    rows, want = _model_reference(L, 2)
    buf = np.zeros(base + rows.size + 32, dtype=np.uint8)
    buf[base:base + rows.size] = rows.reshape(-1)
    tables = crc_bytes_tables(crc_nseg(L), device="cpu")
    assert _emulate_crc_bytes_kernel(buf, base, 2, L, tables) == want


def test_crc_bytes_kernel_emulation_ragged_first_run():
    """One row of 1 000 000 bytes (chip_smoke's odd chunk): S = 1954, 123
    runs, the first one of 2 segments, the front pad 448 bytes."""
    L = 1_000_000
    assert (crc_nseg(L), cc.crc_bytes_runs(crc_nseg(L))) == (1954, 123)
    rows, want = _model_reference(L, 1)
    buf = np.zeros(3 + L + 32, dtype=np.uint8)
    buf[3:3 + L] = rows[0]
    tables = crc_bytes_tables(crc_nseg(L), device="cpu")
    assert _emulate_crc_bytes_kernel(buf, 3, 1, L, tables) == want


def test_wrappers_reject_bad_input():
    tables = crc_bytes_tables(2, device="cpu")
    with pytest.raises(TypeError):
        cc.crc_bytes_raw(torch.zeros(2, 1000, dtype=torch.int32), tables)
    with pytest.raises(ValueError):
        cc.crc_bytes_raw(torch.zeros(2, 1500, dtype=torch.uint8), tables)
    with pytest.raises(ValueError):
        cc.crc_seg_bytes(torch.zeros(2, 1000, dtype=torch.uint8), tables)
    with pytest.raises(ValueError):
        cc.make_crc32c_raw_fast(1000, device="cpu")


def test_plain_versions_never_count_launches():
    cc.reset_launches()
    cc.make_crc32c_bytes(1000, device="cpu")(torch.zeros(2, 1000, dtype=torch.uint8))
    cc.make_stripe_encode_step_fast(512, 6, 3, device="cpu")(
        torch.zeros(1, 6, 512, dtype=torch.uint8))
    assert cc.launches["crc_bytes"] == 0 and not any(cc.launches.values())


def test_empty_rows_have_crc_zero():
    rows = torch.zeros(3, 0, dtype=torch.uint8)
    assert cc.make_crc32c_bytes(0, device="cpu")(rows).tolist() == [0, 0, 0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_crc_bytes_kernel_matches_plain_on_gpu(cuda_device):
    """On the card: B6 against its plain version at odd lengths (up to a
    ragged first run of 2 segments at 1 000 000 bytes and 4 MiB - 5), and on
    views whose rows start at every offset 0..15 from a 16-byte boundary
    (bit-exact)."""
    cc.reset_launches()
    lengths = (1, 9, 511, 513, 4093, 70000, 1_000_000, (4 << 20) - 5)
    for L in lengths:
        tables = crc_bytes_tables(crc_nseg(L), device=cuda_device)
        rows = torch.from_numpy(_bytes(3 if L > 70000 else 5, L)).to(cuda_device)
        assert torch.equal(cc.crc_bytes_raw(rows, tables),
                           cc.crc_bytes_raw_plain(rows, tables)), L
    L = 1000
    tables = crc_bytes_tables(crc_nseg(L), device=cuda_device)
    flat = torch.from_numpy(rng.integers(0, 256, 4 * L + 16, dtype=np.uint8)).to(cuda_device)
    for off in range(16):
        view = flat[off:off + 4 * L].view(4, L)
        assert torch.equal(cc.crc_bytes_raw(view, tables),
                           cc.crc_bytes_raw_plain(view.contiguous(), tables)), off
    torch.cuda.synchronize()
    assert cc.launches["crc_bytes"] == len(lengths) + 16
