"""The port's fuse_main (t3fs_torch/app/fuse_main.py) against the
reference's t3fs/app/fuse_main.py: its config (defaults, validators,
--set overrides, the StorageClientConfig it builds, the deploy tool's
fuse.toml), then `python -m t3fs_torch.app.fuse_main` as a user runs it,
mounting the port's DevCluster (its processes on the host CRC): a POSIX
round trip through the mountpoint, SIGTERM giving exit 0 and leaving no
mount.  The child reports its imports, which hold no jax, nothing of the
JAX package and no torch."""

import asyncio
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from t3fs.app import base as ref_base
from t3fs.app import fuse_main as ref_fm
from t3fs_torch.app import base as port_base
from t3fs_torch.app import fuse_main as port_fm
from torch_fuse_mounts import fuse_tmp, needs_fuse  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent

OVERRIDES = ["mgmtd_address=10.0.0.7:9000", "mountpoint=/mnt/t3fs",
             "client_id=fuse-a", "max_write=1048576", "readonly=true",
             "attr_timeout=0.5", "entry_timeout=2.5", "sync_on_stat=true",
             "group_source=host", "storage.read_selection=adaptive",
             "storage.read_hedging=on", "storage.hedge_delay_floor_ms=1.5",
             "storage.hedge_delay_cap_ms=80.0", "storage.hedge_budget_pct=0.2",
             "storage.hedge_budget_burst=3", "log.level=DEBUG"]
BAD = [{"max_write": 1024}, {"attr_timeout": -1.0}, {"entry_timeout": 3601.0},
       {"group_source": "ldap"}, {"storage": {"read_selection": "random"}},
       {"storage": {"read_hedging": "maybe"}},
       {"storage": {"hedge_budget_pct": 1.5}},
       {"storage": {"hedge_delay_floor_ms": -1.0}},
       {"storage": {"hedge_budget_burst": -2}}]


def _client_cfg(cfg) -> dict:
    return {k: (int(v) if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(cfg.storage.client_config()).items()}


def test_config_defaults_and_client_config_equal_reference():
    ref, port = ref_fm.FuseMainConfig(), port_fm.FuseMainConfig()
    assert port.to_dict() == ref.to_dict()
    assert port.max_write == 1 << 17 and port.group_source == "registry"
    assert _client_cfg(port) == _client_cfg(ref)
    assert port_fm.StorageTuning().to_dict() == ref_fm.StorageTuning().to_dict()


def test_config_overrides_and_validators_equal_reference():
    ref, port = ref_fm.FuseMainConfig(), port_fm.FuseMainConfig()
    ref.update(ref_base.parse_overrides(OVERRIDES), hot_only=False)
    port.update(port_base.parse_overrides(OVERRIDES), hot_only=False)
    ref.validate()
    port.validate()
    assert port.to_dict() == ref.to_dict()
    assert port.storage.read_selection == "adaptive" and port.readonly is True
    assert _client_cfg(port) == _client_cfg(ref)
    for bad in BAD:
        errors = []
        for cls in (ref_fm.FuseMainConfig, port_fm.FuseMainConfig):
            with pytest.raises(ValueError) as ei:
                cls().update(bad, hot_only=False)
            errors.append(type(ei.value).__name__)
        assert errors[0] == errors[1], (bad, errors)
    # non-hot keys refuse a hot update in both
    for cls in (ref_fm.FuseMainConfig, port_fm.FuseMainConfig):
        with pytest.raises(ValueError):
            cls().update({"mountpoint": "/elsewhere"}, hot_only=True)
        cfg = cls()
        assert cfg.update({"storage": {"read_hedging": "on"}}) == \
            ["storage.read_hedging"]


def test_deploy_fuse_toml_parses_equal(tmp_path):
    out = tmp_path / "etc"
    subprocess.run(
        [sys.executable, "deploy/gen_configs.py", "--out", str(out),
         "--mgmtd", "10.0.0.1:9000", "--kv", "10.0.0.1", "--meta",
         "10.0.0.1", "--storage", "10.0.0.3", "--targets-per-node", "1",
         "--replicas", "1"], cwd=ROOT, check=True, capture_output=True)
    path = str(out / "fuse.toml")
    port = port_fm.FuseMainConfig.from_toml(path)
    assert port.to_dict() == ref_fm.FuseMainConfig.from_toml(path).to_dict()
    assert port.mgmtd_address == "10.0.0.1:9000" and port.mountpoint


def _imported(stderr: str) -> set[str]:
    return {line.rsplit("|", 1)[1].strip() for line in stderr.splitlines()
            if line.startswith("import time:") and line.count("|") == 2}


def _wait_mounted(mnt: str, proc, timeout_s: float = 60.0) -> float:
    t0 = time.monotonic()
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"fuse_main exited {proc.returncode}")
        if os.path.ismount(mnt) and sorted(os.listdir(f"{mnt}/t3fs-virt")) == [
                "get-conf", "rm-rf", "set-conf"]:
            return time.monotonic() - t0
        assert time.monotonic() - t0 < timeout_s, "no mount within the limit"
        time.sleep(0.05)


@needs_fuse
def test_fuse_main_mounts_a_dev_cluster(fuse_tmp):
    from t3fs_torch.app.dev_cluster import DevCluster

    tmp_path = Path(fuse_tmp)
    blob = np.random.default_rng(2026).integers(
        0, 256, 300_000, dtype=np.uint8).tobytes()
    c = DevCluster(str(tmp_path / "run"), num_storage=1, replicas=1,
                   chunk_size=64 << 10, heartbeat_timeout_s=60.0,
                   checksum_backend="cpu")
    mnt = str(tmp_path / "mnt")
    os.makedirs(mnt)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), PYTHONPROFILEIMPORTTIME="1")
    proc = None
    out_path = tmp_path / "fuse.out"     # the import report is long: a file,
    try:                                 # never a pipe the child could fill
        asyncio.run(asyncio.wait_for(c.start(), 240))
        with open(out_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "t3fs_torch.app.fuse_main",
                 "--set", f"mgmtd_address={c.mgmtd_address}",
                 "--set", f"mountpoint={mnt}"],
                cwd=tmp_path, env=env, stdout=out, stderr=subprocess.STDOUT)
        _wait_mounted(mnt, proc)
        # POSIX calls from this process: the mount's loop is the child's
        os.mkdir(f"{mnt}/d")
        with open(f"{mnt}/d/blob", "wb") as f:
            f.write(blob)
        assert os.stat(f"{mnt}/d/blob").st_size == len(blob)
        with open(f"{mnt}/d/blob", "rb") as f:
            assert f.read() == blob
        os.rename(f"{mnt}/d/blob", f"{mnt}/d/moved")
        assert os.listdir(f"{mnt}/d") == ["moved"]
        assert os.readlink(f"{mnt}/t3fs-virt/get-conf/attr_timeout") == "1.0"
        os.unlink(f"{mnt}/d/moved")
        os.rmdir(f"{mnt}/d")
        assert os.listdir(mnt) == []
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        err = out_path.read_text()
        assert proc.returncode == 0, err[-3000:]
        assert not os.path.ismount(mnt)
        mods = _imported(err)
        assert "t3fs_torch.fuse.kernel" in mods
        assert "torch" not in mods          # a client process: no torch at all
        bad = sorted(m for m in mods if m.split(".")[0] in (
            "jax", "jaxlib", "t3fs", "benchmarks"))
        assert not bad, bad
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        asyncio.run(c.stop())
