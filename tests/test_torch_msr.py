"""The pm-msr code on the port: its copy of ops/msr.py against the JAX
package's (schedules, generator, decode matrices), and the three device
steps (t3fs_torch.ops.msr_codec on CPU tensors, so the kernels' plain
versions run) against the JAX package's make_msr_*_step -- on its Pallas
word path in interpret mode (L = 16384) and on its XLA byte path (L = 4032,
4064) -- and against encode_np / repair_np / decode_np.

Mirrors tests/test_msr.py:86-141: every single-loss slot, and the masks
(0, 1), (4, 9) and (8, 9).  Every comparison is bit-exact."""

import numpy as np
import pytest
import torch

from t3fs.ops import msr as ref_msr
from t3fs.ops import msr_codec as ref_mc
from t3fs.ops import pallas_codec as pc
from t3fs.ops.crc32c import crc32c_ref
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops import msr as msr
from t3fs_torch.ops import msr_codec as mc

rng = np.random.default_rng(43)
CODE, REF = msr.default_msr(8, 2), ref_msr.default_msr(8, 2)
MASKS = [(0, 1), (4, 9), (8, 9)]


def _stored(L: int) -> np.ndarray:
    """(k+m, L) stored shards: random data, parity by the reference oracle."""
    data = rng.integers(0, 256, (REF.k, L), dtype=np.uint8)
    return np.concatenate([data, REF.encode_np(data)])


def _helper_rows(stored: np.ndarray, f: int) -> np.ndarray:
    sch = REF.schedule(f)
    sub = stored.shape[1] // REF.alpha
    return np.stack([stored[h].reshape(REF.alpha, sub)[list(sch.selected)].reshape(-1)
                     for h in sch.helpers])


def _present(lost):
    return tuple(s for s in range(REF.n) if s not in lost)[:REF.k]


def test_msr_code_constants_match_reference():
    for attr in ("k", "m", "n", "d", "t", "alpha", "beta", "gamma", "delta",
                 "inv_gamma", "inv_delta", "g_inv_delta", "code_id"):
        assert getattr(CODE, attr) == getattr(REF, attr), attr
    assert msr.msr_code_id(8, 2) == ref_msr.msr_code_id(8, 2)
    assert np.array_equal(CODE.generator(), REF.generator())
    for lost in MASKS:
        assert np.array_equal(CODE.decode_matrix(_present(lost), lost),
                              REF.decode_matrix(_present(lost), lost)), lost


@pytest.mark.parametrize("f", range(10))
def test_msr_schedule_arrays_match_reference(f):
    """Every array a device step loads from a schedule is the reference's."""
    mine, ref = CODE.schedule(f), REF.schedule(f)
    for attr in ("selected", "npl", "helpers", "partner", "partner_hidx",
                 "present8", "idx_f", "idx_p", "nonsel", "read_subchunks"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    for attr in ("copy_mask", "src_own", "src_pair", "out_sel"):
        assert np.array_equal(getattr(mine, attr), getattr(ref, attr)), attr
    for attr in ("prog_pair", "prog_f", "prog_p", "prog_out"):
        a, b = getattr(mine, attr), getattr(ref, attr)
        assert (a.coeffs, a.planes) == (b.coeffs, b.planes), attr
    assert mine.read_runs() == ref.read_runs()


def test_msr_numpy_oracles_match_reference():
    stored = _stored(2048)
    assert np.array_equal(CODE.encode_np(stored[:8]), stored[8:])
    sub = 2048 // CODE.alpha
    for f in (0, 3, 9):
        H = _helper_rows(stored, f).reshape(CODE.d, CODE.beta, sub)
        assert np.array_equal(CODE.repair_np(f, H), stored[f])
    for lost in MASKS:
        p = _present(lost)
        assert np.array_equal(CODE.decode_np(p, stored[list(p)], lost),
                              REF.decode_np(p, stored[list(p)], lost))


def test_decode_bitmatrix_matches_reference_expansion():
    """decode_bitmatrix_t is the plane-major form of the JAX step's
    gfmat_to_bitmatrix(M).T."""
    for lost in MASKS:
        M = REF.decode_matrix(_present(lost), lost)
        Wb = REF.gf.gfmat_to_bitmatrix(M).T                    # (8 ka, 8 na)
        pk, pn = pc._plane_major_perm(M.shape[1]), pc._plane_major_perm(M.shape[0])
        assert np.array_equal(mc.decode_bitmatrix_t(CODE, _present(lost), lost),
                              Wb[np.ix_(pk, pn)].T)


@pytest.mark.parametrize("L,words", [(16384, True), (4064, False)],
                         ids=["pallas-words", "xla-bytes"])
def test_msr_encode_step_matches_reference(L, words):
    stored = _stored(L)
    data = stored[None, :8]
    parity, crcs = mc.make_msr_encode_step(CODE, L, device="cpu")(torch.from_numpy(data))
    rpar, rcrc = ref_mc.make_msr_encode_step(REF, L, interpret=words, use_pallas=words)(data)
    assert np.array_equal(parity.numpy(), np.asarray(rpar))
    assert np.array_equal(crcs.numpy().view(np.uint32), np.asarray(rcrc))
    assert np.array_equal(parity[0].numpy(), stored[8:])
    assert [int(c) for c in crcs.numpy().view(np.uint32)[0]] == \
        [crc32c_ref(r.tobytes()) for r in stored]


@pytest.mark.parametrize("L,words", [(16384, True), (4032, False)],
                         ids=["pallas-words", "xla-bytes"])
@pytest.mark.parametrize("f", range(10))
def test_msr_repair_step_matches_reference(f, L, words):
    """Every single-loss slot, both of the reference's dispatch paths."""
    stored = _stored(L)
    rows = _helper_rows(stored, f)[None]
    out, crc = mc.make_msr_repair_step(CODE, f, L, device="cpu")(torch.from_numpy(rows))
    rout, rcrc = ref_mc.make_msr_repair_step(REF, f, L, interpret=words,
                                             use_pallas=words)(rows)
    assert np.array_equal(out.numpy(), np.asarray(rout))
    assert np.array_equal(crc.numpy().view(np.uint32), np.asarray(rcrc))
    assert np.array_equal(out[0].numpy(), stored[f])
    sub = L // CODE.alpha
    assert np.array_equal(out[0].numpy(),
                          REF.repair_np(f, rows[0].reshape(CODE.d, CODE.beta, sub)))


@pytest.mark.parametrize("L", [2048, 4032])
@pytest.mark.parametrize("lost", MASKS)
def test_msr_decode_step_matches_reference(lost, L):
    stored = _stored(L)
    p = _present(lost)
    rows = np.ascontiguousarray(stored[list(p)])[None]
    out, crcs = mc.make_msr_decode_step(CODE, p, lost, L, device="cpu")(
        torch.from_numpy(rows))
    rout, rcrc = ref_mc.make_msr_decode_step(REF, p, lost, L)(rows)
    assert np.array_equal(out.numpy(), np.asarray(rout))
    assert np.array_equal(crcs.numpy().view(np.uint32), np.asarray(rcrc))
    assert np.array_equal(out[0].numpy(), REF.decode_np(p, rows[0], lost))
    assert np.array_equal(out[0].numpy(), stored[list(lost)])


def test_msr_decode_step_batches_stripes(monkeypatch):
    """Stripes go through the decode product in groups; the groups' split
    does not change a byte."""
    L = 2048
    stored = np.stack([_stored(L) for _ in range(3)])
    p, lost = _present((4, 9)), (4, 9)
    rows = torch.from_numpy(np.ascontiguousarray(stored[:, list(p)]))
    whole = mc.make_msr_decode_step(CODE, p, lost, L, device="cpu")(rows)
    monkeypatch.setattr(mc, "_DECODE_PLANE_BYTES", 1)     # one stripe a group
    split = mc.make_msr_decode_step(CODE, p, lost, L, device="cpu")(rows)
    assert torch.equal(whole[0], split[0]) and torch.equal(whole[1], split[1])
    assert np.array_equal(split[0].numpy(), stored[:, list(lost)])


def test_msr_steps_never_count_launches():
    cc.reset_launches()
    stored = _stored(2048)
    mc.make_msr_encode_step(CODE, 2048, device="cpu")(torch.from_numpy(stored[None, :8]))
    mc.make_msr_repair_step(CODE, 3, 2048, device="cpu")(
        torch.from_numpy(_helper_rows(stored, 3)[None]))
    assert not any(cc.launches.values())


def test_mulc_matches_field_multiply():
    """The SWAR constant multiply on both lane types equals GF256.mul."""
    x = rng.integers(0, 256, 64, dtype=np.uint8)
    for c in (1, 2, 3, 0x1D, 0x8E, 255):
        want = CODE.gf.mul(c, x)
        got8 = mc._make_mulc(False, 0x1D)(torch.from_numpy(x), c)
        got32 = mc._make_mulc(True, 0x1D)(torch.from_numpy(x.view(np.int32)), c)
        assert np.array_equal(got8.numpy(), want)
        assert np.array_equal(got32.numpy().view(np.uint8), want)
    with pytest.raises(ValueError):
        mc._make_mulc(True, 0x1D)(torch.zeros(4, dtype=torch.int32), 0)
