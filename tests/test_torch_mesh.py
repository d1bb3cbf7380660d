"""The port's (dp, cp) codec mesh on torch.distributed against the JAX
package's mesh on the conftest's virtual CPU devices.

`t3fs_torch.graft_entry.dryrun_multichip` spawns its ranks on gloo
(device="cpu"), runs the four sharded steps of
`t3fs_torch.parallel.codec_mesh` on its tiny stripes and checks them
against RSCode and crc32c_ref itself; here every global output is also
held, bit for bit, against `t3fs.parallel.codec_mesh`'s steps on the same
numpy inputs (the Pallas word kernels in interpret mode), at dp x cp =
1 x 2, 2 x 2 and make_mesh's default for 4 ranks (1 x 4).  One spawn a
topology serves all of its tests.  The `cuda`-marked twin runs the 2 x 2
mesh on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t3fs.ops.crc32c import crc32c_ref
from t3fs.parallel import codec_mesh as jm
from t3fs_torch import graft_entry as ge
from t3fs_torch.parallel import codec_mesh as tm

# (ranks, dp given to make_mesh); None takes make_mesh's default
TOPOLOGIES = [(2, None), (4, 2), (4, None)]
IDS = ["1x2", "2x2", "1x4"]


def _jax_outputs(n: int, dp: int | None, full: np.ndarray,
                 full63: np.ndarray) -> dict:
    """The JAX mesh's global outputs, named as run_mesh names the port's."""
    mesh = jm.make_mesh(n, dp)
    L = full.shape[2]
    stripes = full[:, :ge.K]
    want = ge.DRYRUN_WANT
    present = ge.present_of(want, ge.K, ge.M)
    surv = full[:, list(present)]
    present63 = ge.present_of(ge.LOST63, ge.K63, ge.M63)

    def run(made, x):
        step, sharding = made
        return [np.asarray(a) for a in step(jax.device_put(jnp.asarray(x), sharding))]

    out = {}
    out["enc_parity"], out["enc_crcs"] = run(jm.make_sharded_encode_step(mesh, L), stripes)
    t = ge.want_tag(want)
    out[f"rec{t}"], out[f"rec{t}_crcs"] = run(
        jm.make_sharded_reconstruct_step(mesh, L, present, want), surv)
    words = np.ascontiguousarray(stripes).view(np.uint32)
    out["wenc_parity"], out["wenc_crcs"] = run(
        jm.make_sharded_encode_step_words(mesh, L // 4, interpret=True), words)
    out[f"wrec{t}"], out[f"wrec{t}_crcs"] = run(
        jm.make_sharded_reconstruct_step_words(mesh, L, present, want, interpret=True),
        surv)
    out["wrec63"], out["wrec63_crcs"] = run(
        jm.make_sharded_reconstruct_step_words(
            mesh, L, present63, ge.LOST63, ge.K63, ge.M63, interpret=True),
        full63[:, list(present63)])
    return out


@pytest.fixture(scope="module", params=TOPOLOGIES, ids=IDS)
def meshes(request):
    """(topology, the port's dryrun result, the JAX outputs, the stripes)."""
    n, dp = request.param
    res = ge.dryrun_multichip(n, dp, device="cpu")
    full, full63 = ge.dryrun_stripes(res["dp"], res["cp"])
    return request.param, res, _jax_outputs(n, dp, full, full63), full


def _same(res: dict, want: dict, *names: str) -> None:
    for name in names:
        got = res["outputs"][name]
        assert got.dtype == want[name].dtype, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_mesh_shape_is_the_references(meshes):
    (n, dp), res, _, _ = meshes
    assert (res["dp"], res["cp"]) == tuple(jm.make_mesh(n, dp).shape.values())
    assert res["backend"] == "gloo" and res["ranks_per_card"] == 0
    assert sorted((r["dp_index"], r["cp_index"]) for r in res["ranks"]) == [
        (i, j) for i in range(res["dp"]) for j in range(res["cp"])]
    # the CPU runs the plain versions: no kernel was launched, nothing timed
    assert all(v == 0 for r in res["ranks"] for v in r["launches"].values())
    assert all(r["ms"] == {} for r in res["ranks"])


def test_byte_encode_matches_jax_mesh(meshes):
    _, res, want, _ = meshes
    _same(res, want, "enc_parity", "enc_crcs")


def test_byte_decode_matches_jax_mesh(meshes):
    _, res, want, _ = meshes
    t = ge.want_tag(ge.DRYRUN_WANT)
    _same(res, want, f"rec{t}", f"rec{t}_crcs")


def test_word_encode_matches_jax_mesh(meshes):
    _, res, want, _ = meshes
    _same(res, want, "wenc_parity", "wenc_crcs")


def test_word_decode_raid6_matches_jax_mesh(meshes):
    _, res, want, _ = meshes
    t = ge.want_tag(ge.DRYRUN_WANT)
    _same(res, want, f"wrec{t}", f"wrec{t}_crcs")


def test_word_decode_rs63_matches_jax_mesh(meshes):
    _, res, want, _ = meshes
    _same(res, want, "wrec63", "wrec63_crcs")


def test_crcs_match_crc32c_ref(meshes):
    _, res, _, full = meshes
    out = res["outputs"]
    for i, row in enumerate(full):
        assert [int(c) for c in out["enc_crcs"][i]] == [
            crc32c_ref(s.tobytes()) for s in row]
        assert [int(c) for c in out["wenc_crcs"][i]] == [
            crc32c_ref(s.tobytes()) for s in row]


@pytest.mark.parametrize("n,dp", [(1, None), (2, None), (3, None), (4, None),
                                  (6, None), (8, None), (8, 2), (8, 8), (4, 4)])
def test_mesh_shape_factors_as_the_reference(n, dp):
    assert tm.mesh_shape(n, dp) == tuple(jm.make_mesh(n, dp).shape.values())


@pytest.mark.parametrize("n,dp", [(4, 2), (4, None), (8, 2)])
def test_shard_takes_the_reference_block(n, dp):
    """Rank r's block is the one JAX's P('dp', None, 'cp') sharding gives
    the device at (r // cp, r % cp) of make_mesh's device array."""
    jmesh = jm.make_mesh(n, dp)
    dpn, cpn = tm.mesh_shape(n, dp)
    shape = (2 * dpn, 3, 8 * cpn)
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    index = jax.NamedSharding(jmesh, jax.sharding.PartitionSpec(
        "dp", None, "cp")).devices_indices_map(shape)
    devs = np.array(jmesh.devices)
    for r in range(n):
        mesh = tm.Mesh(dpn, cpn, r // cpn, r % cpn, None, torch.device("cpu"))
        block = tm.shard(torch.from_numpy(x), mesh).numpy()
        np.testing.assert_array_equal(block, x[index[devs[r // cpn, r % cpn]]])


def test_mesh_backend_rule(monkeypatch):
    assert ge.mesh_backend(4, "cpu") == ("gloo", ["cpu"] * 4, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ge.mesh_backend(4) == ("gloo", ["cuda:0"] * 4, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ge.mesh_backend(4) == ("gloo", ["cuda:0"] * 4, 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert ge.mesh_backend(4) == ("nccl", [f"cuda:{r}" for r in range(4)], 1)
    assert ge.mesh_backend(2) == ("nccl", ["cuda:0", "cuda:1"], 1)


def test_a_failing_rank_fails_the_call():
    """A chunk length that does not split into whole segments: every rank
    raises in its step, and the call raises instead of hanging."""
    full, full63 = ge.dryrun_stripes(1, 2)
    with pytest.raises(Exception, match="whole"):
        ge.run_mesh(2, full[:, :ge.K, :1000], full63[:, :ge.K63, :1000],
                    (ge.DRYRUN_WANT,), device="cpu", timeout_s=60)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the word kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_on_the_card(cuda_device):
    """The 2 x 2 mesh on the card (NCCL with 4 cards, else gloo with the
    ranks sharing them) equals the CPU mesh and the unsharded word step,
    and launched B1, B2, B3 and B5."""
    from t3fs_torch.ops import cuda_codec as cc

    res = ge.dryrun_multichip(4, 2)
    plain = ge.dryrun_multichip(4, 2, device="cpu")
    for name, got in res["outputs"].items():
        np.testing.assert_array_equal(got, plain["outputs"][name], err_msg=name)
    full, _ = ge.dryrun_stripes(2, 2)
    words = torch.from_numpy(np.ascontiguousarray(full[:, :ge.K]).view(np.int32))
    parity, crcs = cc.make_stripe_encode_step_words(words.shape[2])(words.cuda())
    np.testing.assert_array_equal(res["outputs"]["wenc_parity"],
                                  parity.cpu().numpy().view(np.uint32))
    np.testing.assert_array_equal(res["outputs"]["wenc_crcs"],
                                  crcs.cpu().numpy().view(np.uint32))
    for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words", "rs_bitmatmul"):
        assert all(r["launches"][name] > 0 for r in res["ranks"]), name
