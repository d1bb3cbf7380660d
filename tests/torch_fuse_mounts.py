"""Shared pieces of the tests that mount the port's kernel FUSE mount (and
the reference's beside it): whether this host can mount, and a temporary
directory that fails its test if a fuse.t3fs mount is left under it.
Imported by tests/test_torch_fuse_*.py."""

import ctypes
import ctypes.util
import os
import shutil
import tempfile

import pytest

fuse_available = os.path.exists("/dev/fuse") and os.geteuid() == 0

needs_fuse = pytest.mark.skipif(
    not fuse_available, reason="needs /dev/fuse and root")

MNT_DETACH = 2


def fuse_mounts_under(root: str) -> list[str]:
    """Mountpoints of fuse.t3fs mounts below root, from /proc/self/mounts."""
    root = os.path.realpath(root)
    out = []
    with open("/proc/self/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) > 2 and parts[2] == "fuse.t3fs":
                mnt = parts[1].replace("\\040", " ")
                if mnt == root or mnt.startswith(root + "/"):
                    out.append(mnt)
    return out


@pytest.fixture
def fuse_tmp():
    """A temporary directory for one test's mounts.  After the test, no
    fuse.t3fs mount may be left under it: a leak fails the test and is
    detached, so later tests' rmtree calls do not hang on it."""
    tmp = tempfile.mkdtemp(prefix="t3fs-torch-fuse-")
    try:
        yield tmp
    finally:
        left = fuse_mounts_under(tmp)
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        for mnt in left:
            libc.umount2(mnt.encode(), MNT_DETACH)
        shutil.rmtree(tmp, ignore_errors=True)
    assert not left, f"fuse.t3fs mounts left behind: {left}"
