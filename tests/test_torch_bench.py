"""The port's bench path on CPU tensors against the JAX package's: H1's
plain version against the Pallas copy kernel in interpret mode, the chained
harness's carry against benchmarks/devbench.py's, the headline bench's
group arithmetic on synthetic samples, and the decode microbench's ops
against the Pallas kernels the reference microbench builds.  Every
comparison is bit-exact."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from benchmarks import devbench as ref_devbench
from t3fs.ops import pallas_codec as pc
from t3fs.ops.blocks import pick_block
from t3fs.ops.rs import default_rs as ref_default_rs
from t3fs_torch import bench
from t3fs_torch.benchmarks import devbench
from t3fs_torch.benchmarks import ec_recovery_bench as ecb
from t3fs_torch.ops import cuda_codec as cc

rng = np.random.default_rng(41)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the reference's make_copy3d in interpret mode: it looks
    pallas_call up on the module at call time."""
    monkeypatch.setattr(jax_pallas, "pallas_call",
                        functools.partial(jax_pallas.pallas_call, interpret=True))


def _copy_input(shape=(2, 8, 16384)) -> np.ndarray:
    x = rng.integers(0, 2**32, shape, dtype=np.uint32)
    x.reshape(-1)[:3] = [0xFFFFFFFF, 0x7FFFFFFF, 0]       # the wraps
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("fn", [devbench.copy3d_plain, devbench.make_copy3d])
def test_copy3d_matches_pallas(fn, pallas_interpret):
    x = _copy_input()
    ref = np.asarray(ref_devbench.make_copy3d(jnp.asarray(x))).reshape(x.shape)
    got = fn(_t(x))
    assert got.shape == x.shape and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert got.numpy().view(np.uint32).reshape(-1)[:3].tolist() == [0, 0x80000000, 1]


def test_copy3d_plain_never_counts_launches():
    devbench.reset_launches()
    devbench.make_copy3d(torch.zeros(3, 5, 1001, dtype=torch.int32))
    assert devbench.launches["copy3d"] == 0


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(2, 8, 4, dtype=torch.int64), TypeError),
    (torch.zeros(8, 4, dtype=torch.int32), ValueError),
    (torch.zeros(2, 8, 8, dtype=torch.int32)[:, :, ::2], ValueError)])
def test_copy3d_rejects_bad_input(bad, err):
    with pytest.raises(err):
        devbench.make_copy3d(bad)


def test_chained_acc_copy_matches_jax(pallas_interpret):
    x = _copy_input()
    ref = int(ref_devbench._build_chained(ref_devbench.make_copy3d, 3)(jnp.asarray(x)))
    xt = _t(x)
    before = xt.clone()
    assert devbench.chained_acc(devbench.make_copy3d, xt, 3) == ref
    assert torch.equal(xt, before)                 # the caller's tensor is intact


def test_chained_acc_stripe_step_matches_jax():
    x = rng.integers(0, 2**32, (2, 8, 256), dtype=np.uint32)
    jstep = pc.make_stripe_encode_step_words(256, interpret=True)
    ref = int(ref_devbench._build_chained(jstep, 3)(jnp.asarray(x)))
    step = cc.make_stripe_encode_step_words(256, device="cpu")
    assert devbench.chained_acc(step, _t(x), 3) == ref


def test_chained_acc_folds_both_ends_of_every_output():
    """One iteration's acc is first ^ last of each output, | 1; the next
    iteration sees its input XORed with it."""
    x = torch.tensor([[[4, 5, 6]]], dtype=torch.int32)
    seen = []

    def op(v):
        seen.append(v.clone())
        return v, v[..., :2] * 2
    acc = devbench.chained_acc(op, x, 2)
    first = (4 ^ 6) ^ (8 ^ 10) | 1
    assert torch.equal(seen[1], x ^ first)
    v = seen[1].reshape(-1).tolist()
    assert acc == ((v[0] ^ v[2]) ^ (2 * v[0] ^ 2 * v[1])) | 1


def test_timers_need_a_cuda_tensor():
    x = torch.zeros(1, 1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA events"):
        devbench.chained_timer(devbench.make_copy3d, x, 2)
    with pytest.raises(ValueError, match="CUDA events"):
        devbench.chained_enqueue(devbench.make_copy3d, x, 2)


def test_bench_words_are_the_reference_inputs():
    got = devbench.bench_words((2, 8, 64), device="cpu").numpy().view(np.uint32)
    ref = np.random.default_rng(0).integers(0, 2**32, (2, 8, 64), dtype=np.uint32)
    assert np.array_equal(got, ref)


# --- the headline bench's group arithmetic ------------------------------------

NBYTES = bench.N * bench.K * bench.CHUNK_LEN
D_ITERS = bench.ITERS_HI - bench.ITERS_LO


def _group(op_gbps: float, copy_pass_s: float = 30e-6):
    """Four sample populations whose group gives op time NBYTES/op_gbps and
    perturbation pass copy_pass_s, with noisy extra samples above the mins."""
    t = NBYTES / (op_gbps * 1e9)
    r, c = t + copy_pass_s, copy_pass_s
    lo_r, lo_c = 5e-3, 4e-3
    return ([lo_r + r * D_ITERS, lo_r + r * D_ITERS + 1e-4], [lo_r, lo_r + 2e-4],
            [lo_c + 2 * c * D_ITERS, lo_c + 2 * c * D_ITERS + 3e-4], [lo_c, lo_c + 1e-4])


def _feed(*groups):
    it = iter(groups)
    calls = []

    def next_group():
        calls.append(1)
        return next(it)
    return next_group, calls


def test_cap_is_the_cards_data_rate():
    assert bench.MAX_DATA_BYTES_PER_S == pytest.approx(3.35e12 * 8 / 10)
    src = "".join(Path(m.__file__).read_text() for m in (bench, devbench, ecb))
    assert "819" not in src and "900" not in src


def test_glitched_group_is_resampled_not_floored():
    rh, rl, ch, cl = _group(600.0)
    glitch = (rh, [rh[0] + 1e-3], ch, cl)              # hi - lo < 0
    nxt, calls = _feed(glitch, _group(600.0))
    t_op, t_raw = bench.sample_groups(nxt, 4, D_ITERS, NBYTES)
    assert len(calls) == 2
    assert NBYTES / t_op / 1e9 == pytest.approx(600.0)
    assert t_raw > t_op


def test_group_past_the_v5e_cap_is_kept():
    nxt, calls = _feed(_group(1000.0))
    t_op, _ = bench.sample_groups(nxt, 4, D_ITERS, NBYTES)
    assert NBYTES / t_op / 1e9 == pytest.approx(1000.0)
    assert len(calls) == 1                             # fast: stops at once


def test_group_past_the_cards_cap_is_dropped():
    nxt, calls = _feed(_group(3000.0), _group(700.0))
    t_op, _ = bench.sample_groups(nxt, 4, D_ITERS, NBYTES)
    assert NBYTES / t_op / 1e9 == pytest.approx(700.0) and len(calls) == 2
    nxt, _ = _feed(_group(3000.0))
    assert bench.sample_groups(nxt, 1, D_ITERS, NBYTES) is None


def test_slow_groups_are_all_sampled_and_the_best_kept():
    nxt, calls = _feed(_group(20.0), _group(40.0), _group(30.0))
    t_op, _ = bench.sample_groups(nxt, 3, D_ITERS, NBYTES)
    assert len(calls) == 3 and NBYTES / t_op / 1e9 == pytest.approx(40.0)


def test_calibration_past_the_raw_time_falls_back_to_the_raw_time():
    r, t = bench.group_times([2.0], [1.0], [10.0], [1.0], 1)
    assert t == r == 1.0


def test_bench_refuses_the_cpu():
    with pytest.raises(ValueError, match="no CPU mode"):
        bench.measure(quick=True, device="cpu")


# --- the decode microbench ----------------------------------------------------

def _ref_decode_ops(k, m, L, n):
    """The Pallas ops and inputs the reference microbench builds
    (benchmarks/ec_recovery_bench.py:215-253), in interpret mode."""
    rs = ref_default_rs(k, m)
    present, want = ecb.decode_pattern(k, m)
    survivors = np.random.default_rng(7).integers(0, 256, (n, k, L), dtype=np.uint8)
    words = jnp.asarray(np.ascontiguousarray(survivors).view(np.uint32).reshape(n, k, L // 4))
    ops = {}
    if rs.raid6:
        ops["fused_decode_verify_GB_s"] = (pc.make_stripe_decode_step_words(
            L // 4, present, want, k=k, m=m, interpret=True), words)
        ops["word_reconstruct_GB_s"] = (pc.make_rs_reconstruct_words_pallas(
            present, want, rs, block_w=pick_block(L // 4, 16384), interpret=True), words)
    ops["byteplane_reconstruct_GB_s"] = (pc.make_rs_reconstruct_pallas(
        present, want, rs, block_t=pick_block(L, 32768), interpret=True),
        jnp.asarray(survivors))
    return ops


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    return np.asarray(x)


@pytest.mark.parametrize("k,m", [(8, 2), (6, 3)])
def test_decode_ops_match_the_reference_microbench(k, m):
    L, n = 4096, 2
    got = ecb.decode_ops(k, m, L, n, decode_ab=True, device="cpu")
    ref = _ref_decode_ops(k, m, L, n)
    assert got.keys() == ref.keys()
    for name, (op, x) in got.items():
        rop, rx = ref[name]
        assert np.array_equal(_as_np(x), np.asarray(rx)), name
        outs, routs = op(x), jax.tree_util.tree_leaves(rop(rx))
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert len(outs) == len(routs), name
        for a, b in zip(outs, routs):
            assert np.array_equal(_as_np(a), np.asarray(b)), name


def test_decode_ops_without_the_ab_keep_the_word_path_for_raid6():
    assert list(ecb.decode_ops(8, 2, 512, 1, decode_ab=False, device="cpu")) == [
        "fused_decode_verify_GB_s", "word_reconstruct_GB_s"]
    assert list(ecb.decode_ops(6, 3, 512, 1, decode_ab=False, device="cpu")) == [
        "byteplane_reconstruct_GB_s"]
    with pytest.raises(ValueError):
        ecb.decode_ops(8, 2, 1000, 1, device="cpu")


def test_decode_pattern_lists_k_survivors():
    assert ecb.decode_pattern(8, 2) == (tuple(range(2, 10)), (0, 1))
    assert ecb.decode_pattern(6, 3) == ((2, 3, 4, 5, 6, 7), (0, 1))


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_copy3d_kernel_matches_plain_on_gpu(cuda_device):
    devbench.reset_launches()
    for shape in ((2, 8, 16384), (3, 5, 1001), (1, 1, 3)):
        x = _t(_copy_input(shape)).to(cuda_device)
        assert torch.equal(devbench.make_copy3d(x), devbench.copy3d_plain(x)), shape
    flat = _t(_copy_input((3 * 5 * 1001 + 1,))).to(cuda_device)
    x = flat[1:].view(3, 5, 1001)                      # not 16-byte aligned
    assert torch.equal(devbench.make_copy3d(x), devbench.copy3d_plain(x))
    one = devbench.chained_timer(devbench.make_copy3d, x, 3)
    assert one() > 0
    torch.cuda.synchronize()
    assert devbench.launches["copy3d"] >= 4
