"""The port stands alone: t3fs_torch and chip_smoke import neither jax nor
the JAX package, every entry point defaults to CUDA and refuses to run on
the CPU unasked, and chip_smoke fails without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

IMPORT_ALL = """
import pkgutil, sys
import t3fs_torch
mods = [m.name for m in pkgutil.walk_packages(t3fs_torch.__path__, "t3fs_torch.")]
for name in mods:
    __import__(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "t3fs"
             or m.startswith("t3fs."))
print(len(mods), bad)
assert not bad, bad
for pkg in ("net", "mgmtd", "storage", "client", "testing", "utils"):
    assert f"t3fs_torch.{pkg}" in mods, pkg
"""


def test_port_imports_no_jax_and_no_t3fs():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[0]) >= 50      # every module was imported


def test_port_sources_name_no_jax_or_t3fs_module():
    for path in [*ROOT.glob("t3fs_torch/**/*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "t3fs"), \
                    f"{path}: {s}"


async def _default_fabric(client_writes: bool = False):
    """A storage fabric (and a client writing through it) on the defaults:
    its nodes' checksum backend is the CUDA one, so start() raises."""
    from t3fs_torch.client.layout import FileLayout
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.testing.fabric import StorageFabric

    fabric = StorageFabric(num_nodes=1, replicas=1)
    try:
        await fabric.start()
        if client_writes:
            sc = StorageClient(lambda: fabric.routing, client=fabric.client)
            await sc.write_file_range(
                FileLayout(chunk_size=1 << 20, chains=[fabric.chain_id]),
                inode=1, offset=0, data=b"x" * (1 << 20))
    finally:
        await fabric.stop()


def _entry_points():
    import asyncio

    from t3fs_torch import bench, graft_entry, resolve_device
    from t3fs_torch.benchmarks import devbench, sort_bench
    from t3fs_torch.benchmarks import ec_recovery_bench as ecb
    from t3fs_torch.client.ec_client import ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import (
        cuda_codec, device_sort, msr_codec, tables, torch_codec)
    from t3fs_torch.ops.msr import default_msr
    from t3fs_torch.ops.repair_program import xor_program
    from t3fs_torch.parallel import codec_mesh
    from t3fs_torch.storage.codec_backend import (
        CudaChecksumBackend, make_checksum_backend)
    from t3fs_torch.storage.service import StorageNode

    return [
        resolve_device,
        cuda_codec.make_crc_seg_words,
        lambda: cuda_codec.make_crc32c_words_raw(128),
        lambda: cuda_codec.make_crc32c_words(128),
        cuda_codec.make_rs_encode_words,
        lambda: cuda_codec.make_stripe_encode_step_words(128),
        tables.codec_tables,
        lambda: tables.load_codec_tables(tables.build_codec_tables()),
        lambda: torch_codec.make_crc32c_raw(512),
        lambda: torch_codec.make_crc32c_batch(10),
        torch_codec.make_rs_encode,
        torch_codec.make_rs_encode_matmul,
        lambda: torch_codec.make_stripe_encode_step(512),
        CudaChecksumBackend,
        lambda: make_checksum_backend("tpu"),
        TorchECCodec,
        # the read side
        lambda: cuda_codec.make_rs_reconstruct_words(tuple(range(8)), (8,)),
        lambda: cuda_codec.make_stripe_decode_step_words(
            128, tuple(range(8)), (8, 9)),
        lambda: cuda_codec.make_repair_subshard_words(xor_program(3)),
        lambda: cuda_codec.make_repair_step_words(128, xor_program(3)),
        lambda: cuda_codec.make_rs_reconstruct_bytes(tuple(range(8)), (9,)),
        cuda_codec.make_rs_encode_bytes,
        lambda: torch_codec.make_rs_reconstruct(tuple(range(8)), (9,)),
        lambda: tables.decode_tables(tuple(range(8)), (9,)),
        tables.encode_map_tables,
        lambda: tables.load_gfmap_tables(tables.build_encode_arrays()),
        # the byte path (B6) and pm-msr
        cuda_codec.make_crc_seg_bytes,
        lambda: cuda_codec.make_crc32c_raw_fast(512),
        lambda: cuda_codec.make_crc32c_bytes(10),
        lambda: cuda_codec.make_crc32c_rows(512),
        lambda: cuda_codec.make_stripe_encode_step_fast(512),
        lambda: cuda_codec.make_stripe_encode_step_bytes(1000),
        lambda: cuda_codec.make_stripe_decode_step_bytes(1000, tuple(range(8)), (9,)),
        lambda: cuda_codec.make_repair_step_bytes(1000, xor_program(3)),
        tables.crc_bytes_tables,
        lambda: tables.load_crc_bytes_tables(tables.build_crc_bytes_arrays()),
        lambda: msr_codec.make_msr_encode_step(default_msr(), 2048),
        lambda: msr_codec.make_msr_repair_step(default_msr(), 0, 2048),
        lambda: msr_codec.make_msr_decode_step(default_msr(), tuple(range(8)),
                                               (8, 9), 2048),
        # the bench path
        lambda: devbench.make_copy3d(devbench.bench_words((1, 1, 4))),
        devbench.main,
        lambda: bench.measure(quick=True),
        lambda: ecb.decode_ops(8, 2, 4096, 1),
        lambda: ecb.decode_microbench(ecb.parse_args([])),
        # the device sort, the codec mesh and the graft entry
        device_sort.make_device_sorter,
        lambda: sort_bench.main(["--quick"]),
        graft_entry.entry,
        lambda: graft_entry.dryrun_multichip(4),
        codec_mesh.make_mesh,
        # the CRAQ chain: storage node, fabric, and a client writing to it
        lambda: StorageNode(1, lambda: None, None),
        lambda: asyncio.run(_default_fabric()),
        lambda: asyncio.run(_default_fabric(client_writes=True)),
        # the EC client: its default codec is TorchECCodec() on "cuda"
        lambda: ECStorageClient(None),
    ]


@pytest.mark.parametrize("i", range(53))
def test_entry_points_default_to_cuda_and_raise_without_gpu(i, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entries = _entry_points()
    assert len(entries) == 53
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entries[i]()


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke would run for real")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    # alone in a directory, without the package, it fails as well
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("cmd,key", [
    (["-m", "t3fs_torch.bench"], "metric"),
    (["-m", "t3fs_torch.benchmarks.ec_recovery_bench", "--decode-ab"], "decode_metric"),
    (["-m", "t3fs_torch.benchmarks.b1_probe"], "card")])
def test_benches_fail_without_gpu_with_an_error_line(cmd, key):
    """Without a GPU a bench prints its result line with an error and exits
    non-zero; it never measures the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench would run for real")
    r = subprocess.run([sys.executable, *cmd], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert key in line and "device='cpu'" in line["error"]
    if key == "metric":
        assert line["metric"] == "rs8+2_crc32c_stripe_encode" and line["value"] == 0


def test_sort_bench_cli_fails_without_gpu():
    """Without a GPU `python -m ...sort_bench` exits non-zero before any
    work and prints no result; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the command would run for real")
    r = subprocess.run([sys.executable, "-m", "t3fs_torch.benchmarks.sort_bench",
                        "--quick"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr and "{" not in r.stdout


def test_port_refuses_what_it_has_not_ported():
    """The ring data plane is not ported: asking for it raises, never runs
    another plane."""
    from t3fs_torch.client.storage_client import (
        StorageClient, StorageClientConfig)

    with pytest.raises(ValueError, match="ring"):
        StorageClient(lambda: None,
                      config=StorageClientConfig(data_plane="ring"))


NATIVE_FROM_PORT = """
import sys
from pathlib import Path
from t3fs_torch.storage.aio import AioReadWorker
from t3fs_torch.storage.native_engine import make_engine, native_lib
from t3fs_torch.testing.fabric import StorageFabric
e = make_engine(sys.argv[1], backend="native")
print(type(e).__name__)
e.close()
lib = Path(native_lib()._name).resolve()
assert lib.parent == Path("t3fs_torch/_build").resolve(), lib
assert lib.name.startswith("libnative_storage-"), lib
AioReadWorker.available()
fab = StorageFabric(num_nodes=1, replicas=1, aio_read=True)
assert (StorageFabric.default_engine_backend, StorageFabric.default_aio_read,
        fab.aio_read) == ("native", True, True)
maps = Path("/proc/self/maps").read_text() if Path("/proc/self/maps").exists() else ""
assert "libt3fs_native" not in maps
assert not [m for m in sys.modules if m == "t3fs" or m.startswith("t3fs.")]
"""


def test_port_native_engine_and_aio_come_from_the_port(tmp_path):
    """The native chunk engine and the io_uring reader are the port's own:
    built from t3fs_torch/csrc into t3fs_torch/_build, loaded without the
    reference's library, and the fabric's defaults as in the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", NATIVE_FROM_PORT,
                        str(tmp_path / "root")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["NativeChunkEngine"]
