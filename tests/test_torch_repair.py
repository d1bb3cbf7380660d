"""Reduced-read repair on the port: its copy of repair_program against the
JAX package's, the repair kernel's plain version (t3fs_torch.ops.cuda_codec
B4 on CPU tensors) against make_repair_subshard_words and the fused repair
step against make_repair_step_words (Pallas in interpret mode), and a numpy
emulation of the CUDA kernel's plane-mask evaluation.

Modelled on tests/test_repair_program.py.  Every comparison is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t3fs.ops import pallas_codec as pc
from t3fs.ops import repair_program as ref_rp
from t3fs.ops.crc32c import crc32c_ref
from t3fs.ops.rs import default_rs as ref_default_rs
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops import repair_program as rp
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.tables import load_repair_tables, repair_tables

rng = np.random.default_rng(31)


def _t(byts: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(byts).view(np.int32))


def _programs(rs, ref_rs, k: int, m: int):
    """(port program, reference program) pairs: every single-erasure row
    over the first-k survivors and over a shuffled survivor pick, the
    all-ones rows, and random dense rows."""
    pairs = []
    for lost in range(k + m):
        survivors = [s for s in range(k + m) if s != lost]
        for present in (survivors[:k], sorted(rng.permutation(survivors)[:k].tolist())):
            pairs.append((rp.single_row_program(rs, present, lost),
                          ref_rp.single_row_program(ref_rs, present, lost)))
    for h in range(1, 10):
        pairs.append((rp.xor_program(h), ref_rp.xor_program(h)))
    for _ in range(20):
        row = tuple(int(c) for c in rng.integers(1, 256, rng.integers(1, 12)))
        pairs.append((rp.schedule_repair_program(row),
                      ref_rp.schedule_repair_program(row)))
    return pairs


@pytest.mark.parametrize("k,m", [(8, 2), (4, 2), (6, 3)])
def test_repair_program_matches_reference(k, m):
    """Same planes, op counts and flags as the JAX package's schedule on
    every single-erasure mask, and the same numpy evaluation."""
    rs, ref_rs = default_rs(k, m), ref_default_rs(k, m)
    for mine, ref in _programs(rs, ref_rs, k, m):
        assert mine.coeffs == ref.coeffs
        assert mine.planes == ref.planes
        assert (mine.is_xor, mine.xor_ops, mine.xtimes_ops, mine.naive_xtimes_ops) \
            == (ref.is_xor, ref.xor_ops, ref.xtimes_ops, ref.naive_xtimes_ops)
        helpers = rng.integers(0, 256, (mine.num_helpers, 61), dtype=np.uint8)
        assert np.array_equal(rp.eval_program_np(mine, helpers, rs),
                              ref_rp.eval_program_np(ref, helpers, ref_rs))


def test_schedule_rejects_zero_and_empty_rows():
    for bad in ([3, 0, 5], [], [256]):
        with pytest.raises(ValueError):
            rp.schedule_repair_program(bad)


def _rs8_rows():
    rs = default_rs(8, 2)
    return [rp.xor_program(5), rp.single_row_program(rs, list(range(8)), 9),
            rp.single_row_program(rs, [0, 2, 3, 4, 5, 6, 7, 9], 1)]


@pytest.mark.parametrize("i", range(3))
def test_repair_words_plain_matches_pallas(i):
    prog = _rs8_rows()[i]
    h, L = prog.num_helpers, 2048
    helpers = rng.integers(0, 256, (3, h, L), dtype=np.uint8)
    ref_prog = ref_rp.schedule_repair_program(prog.coeffs)
    ref = pc.make_repair_subshard_words(ref_prog, interpret=True)(
        jnp.asarray(np.ascontiguousarray(helpers).view(np.uint32)))
    got = cc.make_repair_subshard_words(prog, device="cpu")(_t(helpers))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(ref))
    for j in range(3):
        assert np.array_equal(got[j].numpy().view(np.uint8),
                              rp.eval_program_np(prog, helpers[j]))


@pytest.mark.parametrize("lost", [1, 8, 9])
def test_repair_step_words_matches_pallas(lost):
    """Fused rebuild + CRC against the JAX step, and the CRC against
    crc32c_ref of the rebuilt bytes."""
    rs = default_rs(8, 2)
    L = 1024
    present = [s for s in range(10) if s != lost][:8]
    prog = rp.single_row_program(rs, present, lost)
    helpers = rng.integers(0, 256, (2, prog.num_helpers, L), dtype=np.uint8)
    rreb, rcrc = pc.make_repair_step_words(
        L // 4, ref_rp.schedule_repair_program(prog.coeffs), interpret=True)(
        jnp.asarray(np.ascontiguousarray(helpers).view(np.uint32)))
    rebuilt, crcs = cc.make_repair_step_words(L // 4, prog, device="cpu")(_t(helpers))
    assert np.array_equal(rebuilt.numpy().view(np.uint32), np.asarray(rreb))
    assert np.array_equal(crcs.numpy().view(np.uint32), np.asarray(rcrc))
    for j in range(2):
        assert int(crcs[j].numpy().view(np.uint32)) == \
            crc32c_ref(rebuilt[j].numpy().view(np.uint8).tobytes())


def test_repair_tables_from_jax_program():
    """Tables loaded from the JAX package's program equal the port's own."""
    rs, ref_rs = default_rs(8, 2), ref_default_rs(8, 2)
    for mine, ref in _programs(rs, ref_rs, 8, 2):
        a = load_repair_tables(ref.num_helpers, ref.planes, ref_rs.gf.poly)
        assert a == repair_tables(mine, rs)
        assert len(a.groups) == 1 and a.groups[0].masks[-1]
        assert len(a.groups[0].masks) == ref.xtimes_ops + 1


def _emulate_repair_kernel(words: np.ndarray, rep) -> np.ndarray:
    """numpy model of repair_words.cu, one launch a helper group: each helper
    word read once and XORed into the plane sums its bits select, then
    Horner from the group's top plane; groups after the first XOR in."""
    def xtimes(x):
        return (((x << np.uint32(1)) & np.uint32(0xFEFEFEFE))
                ^ (((x >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(rep.poly_low)))

    out = np.zeros_like(words[:, 0])
    for grp in rep.groups:
        S = np.zeros((8,) + words[:, 0].shape, dtype=np.uint32)
        for j in range(grp.count):
            for b in range(len(grp.masks)):
                if (grp.masks[b] >> j) & 1:
                    S[b] ^= words[:, grp.h0 + j]
        acc = np.zeros_like(S[0])
        for b in range(len(grp.masks) - 1, -1, -1):
            acc = xtimes(acc) ^ S[b]
        out ^= acc
    return out


def test_repair_kernel_planes_emulated():
    rs = default_rs(8, 2)
    for mine, _ref in _programs(rs, ref_default_rs(8, 2), 8, 2):
        rep = repair_tables(mine, rs)
        words = rng.integers(0, 2**32, (2, mine.num_helpers, 8), dtype=np.uint32)
        plain = cc.repair_words(torch.from_numpy(words.view(np.int32)), rep)
        assert np.array_equal(_emulate_repair_kernel(words, rep),
                              plain.numpy().view(np.uint32)), mine.coeffs


def test_repair_wrappers_reject_bad_input():
    rep = repair_tables(rp.xor_program(3))
    with pytest.raises(ValueError):
        cc.repair_words(torch.zeros(1, 4, 8, dtype=torch.int32), rep)
    with pytest.raises(TypeError):
        cc.repair_words(torch.zeros(1, 3, 8, dtype=torch.int64), rep)
    with pytest.raises(ValueError):
        cc.make_repair_step_words(100, rp.xor_program(3), device="cpu")
    with pytest.raises(ValueError):
        load_repair_tables(2, ((0,), ()), 0x11D)       # empty top plane
    with pytest.raises(ValueError):
        load_repair_tables(2, ((0, 2),), 0x11D)        # helper 2 of 2
    cc.reset_launches()
    cc.repair_words(torch.zeros(1, 3, 8, dtype=torch.int32), rep)
    assert cc.launches["repair_words"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_repair_kernel_matches_plain_on_gpu(cuda_device):
    """On the card: B4 on every single-row program of RS(8+2) and on the
    all-ones rows, vector and scalar paths, bit-exact."""
    rs = default_rs(8, 2)
    cc.reset_launches()
    progs = [rp.single_row_program(rs, [s for s in range(10) if s != lost][:8], lost)
             for lost in range(10)] + [rp.xor_program(3)]
    for prog in progs:
        rep = repair_tables(prog, rs)
        words = torch.from_numpy(rng.integers(0, 2**32, (3, prog.num_helpers, 256),
                                              dtype=np.uint32).view(np.int32)).to(cuda_device)
        assert torch.equal(cc.repair_words(words, rep), cc.repair_words_plain(words, rep))
        odd = words[:, :, :255].contiguous()
        assert torch.equal(cc.repair_words(odd, rep), cc.repair_words_plain(odd, rep))
    torch.cuda.synchronize()
    assert cc.launches["repair_words"] == 2 * len(progs)
