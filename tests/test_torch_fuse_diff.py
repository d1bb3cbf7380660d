"""The port's kernel FUSE mount against the reference's, at two levels.

(a) Replies, byte for byte.  Each package's FuseKernelMount is built over
its own package's LocalCluster(with_meta=True) the same way and is not
mounted: one seeded sequence of raw request frames (the FUSE in-header
plus body, fixed `unique`, uid and gid) goes through `_dispatch`, and the
reply frames that `_reply` would write to /dev/fuse are captured.  Every
reply frame must be equal.  time.time is pinned (meta stamps inodes with
it, SETATTR's *_NOW and the /t3fs-virt inodes read it), and both meta
clients carry one client id, since the t3fs.lock holder the GETXATTR reply
names is that id.  STATFS answers constants in both.  One field is masked,
by a deliberate difference: the INIT reply's flags, where the port also
sets FUSE_BIG_WRITES, whether the kernel offers it or not, as libfuse 3
does (without it the kernel splits every buffered write into 4 KiB
WRITEs; test_big_writes_where_the_reference_sends_4k pins both).  Every
other byte of the INIT replies is compared.

(b) POSIX through two real mounts.  Both packages' mounts, each over its
own cluster, run one script of syscalls from a worker thread (never the
daemon's loop).  Every step's return value or errno must be equal, with
os.stat's mode, size, nlink, uid, gid and ino compared.  Times are masked
only where the step reads the clock ("now": a create, a write, utime with
no times); times a step sets explicitly are compared.
"""

import asyncio
import ctypes
import ctypes.util
import errno
import json
import os
import stat as statmod
import struct
import time

import numpy as np
import pytest

import t3fs.fuse.kernel as ref_kernel
import t3fs_torch.fuse.kernel as port_kernel
from t3fs.fuse import user_config as ref_ucfg
from t3fs.testing.cluster import LocalCluster as RefCluster
from t3fs_torch.fuse import user_config as port_ucfg
from t3fs_torch.testing.cluster import LocalCluster as PortCluster
from torch_fuse_mounts import fuse_tmp, needs_fuse  # noqa: F401 (fixture)

SEED = 2026
T0 = 1_700_000_000.0
CLIENT_ID = "mc-fuse-diff"

# opcodes and request layouts (include/uapi/linux/fuse.h), written here
# once so both packages read the very same frames
(LOOKUP, FORGET, GETATTR, SETATTR, READLINK, SYMLINK, MKNOD, MKDIR, UNLINK,
 RMDIR, RENAME, LINK, OPEN, READ, WRITE, STATFS, RELEASE, FSYNC, SETXATTR,
 GETXATTR, LISTXATTR, REMOVEXATTR, FLUSH, INIT, OPENDIR, READDIR, RELEASEDIR,
 FSYNCDIR, ACCESS, CREATE, INTERRUPT, DESTROY, READDIRPLUS, RENAME2) = (
    1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 34, 35, 36, 38, 44, 45)
IN_HDR = struct.Struct("<IIQQIIII")
OUT_HDR = struct.Struct("<IiQ")
RW_IN = struct.Struct("<QQIIQII")
SETATTR_IN = struct.Struct("<II6Q8I")
FATTR_MODE, FATTR_UID, FATTR_GID, FATTR_SIZE = 1, 2, 4, 8
FATTR_ATIME, FATTR_MTIME, FATTR_ATIME_NOW, FATTR_MTIME_NOW = 16, 32, 128, 256
ROOT = 1
VIRT_DIR, RMRF_DIR, GETCONF_DIR, SETCONF_DIR = (
    port_ucfg.VIRT_DIR, port_ucfg.RMRF_DIR, port_ucfg.GETCONF_DIR,
    port_ucfg.SETCONF_DIR)
KEY_BASE = port_ucfg.KEY_BASE
FUSE_BIG_WRITES = 1 << 5
FUSE_MAX_PAGES = 1 << 22
# what a Linux kernel offers, in part: async read, big writes, readdirplus
INIT_OFFERED = 1 | FUSE_BIG_WRITES | (1 << 13) | (1 << 14)
INIT_FLAGS_AT = OUT_HDR.size + 12        # fuse_init_out.flags


def z(name: str) -> bytes:
    return name.encode() + b"\0"


def read_in(fh: int, off: int, size: int) -> bytes:
    return RW_IN.pack(fh, off, size, 0, 0, 0, 0)


def setattr_in(valid: int, size=0, atime=0, mtime=0, atime_ns=0, mtime_ns=0,
               mode=0, uid=0, gid=0) -> bytes:
    return SETATTR_IN.pack(valid, 0, 0, size, 0, atime, mtime, 0, atime_ns,
                           mtime_ns, 0, mode, 0, uid, gid, 0)


class Wire:
    """Feeds raw request frames to one unmounted FuseKernelMount and keeps
    each reply frame it would have written to /dev/fuse."""

    def __init__(self, mount):
        self.mount = mount
        self.unique = 1000
        self.steps: list[tuple[str, bytes, bytes | None]] = []
        self._out: list[bytes] = []
        mount._reply = self._capture

    def _capture(self, unique: int, error: int, data: bytes) -> None:
        self._out.append(OUT_HDR.pack(OUT_HDR.size + len(data), error, unique)
                         + data)

    async def op(self, name: str, opcode: int, nodeid: int = 0,
                 body: bytes = b"", uid: int = 0, gid: int = 0) -> bytes:
        self.unique += 1
        msg = IN_HDR.pack(IN_HDR.size + len(body), opcode, self.unique,
                          nodeid, uid, gid, 4242, 0) + body
        n = len(self._out)
        await self.mount._dispatch(msg)
        reply = self._out[n] if len(self._out) > n else None
        self.steps.append((name, msg, reply))
        return reply or b""

    @staticmethod
    def error(reply: bytes) -> int:
        return OUT_HDR.unpack_from(reply)[1]

    async def entry(self, *a, **kw) -> int:
        """An op answered by fuse_entry_out: the new entry's nodeid."""
        reply = await self.op(*a, **kw)
        assert self.error(reply) == 0, (a, self.error(reply))
        return struct.unpack_from("<Q", reply, OUT_HDR.size)[0]

    async def fh(self, *a, at: int = 0, **kw) -> int:
        """An op answered by fuse_open_out (after `at` bytes): its fh."""
        reply = await self.op(*a, **kw)
        assert self.error(reply) == 0, (a, self.error(reply))
        return struct.unpack_from("<Q", reply, OUT_HDR.size + at)[0]


async def request_sequence(w: Wire) -> None:
    """The seeded sequence: every opcode the mount answers, its error
    replies, the /t3fs-virt tree and a readonly user."""
    rng = np.random.default_rng(SEED)
    blob = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    tail = rng.integers(0, 256, 5_000, dtype=np.uint8).tobytes()

    await w.op("init", INIT, 0, struct.pack("<IIII", 7, 31, 1 << 17,
                                            INIT_OFFERED))
    await w.op("init as gVisor offers it", INIT, 0,
               struct.pack("<IIII", 7, 31, 1 << 17, FUSE_MAX_PAGES))
    await w.op("getattr root", GETATTR, ROOT, bytes(16))
    await w.op("statfs", STATFS, ROOT)
    await w.op("lookup missing: ENOENT", LOOKUP, ROOT, z("missing"))
    d = await w.entry("mkdir d", MKDIR, ROOT, struct.pack("<II", 0o755, 0o022)
                      + z("d"))
    await w.op("mkdir d again: EEXIST", MKDIR, ROOT,
               struct.pack("<II", 0o755, 0) + z("d"))
    await w.op("lookup d", LOOKUP, ROOT, z("d"))

    # a file: create, two writes across 4 KiB chunks, flush, fsync, close
    create = struct.pack("<IIII", os.O_WRONLY | os.O_CREAT, 0o100644, 0o022, 0)
    reply = await w.op("create d/f", CREATE, d, create + z("f"))
    f = struct.unpack_from("<Q", reply, OUT_HDR.size)[0]
    fh = struct.unpack_from("<Q", reply, OUT_HDR.size + 128)[0]
    await w.op("write 70000 B", WRITE, f, RW_IN.pack(fh, 0, len(blob), 0, 0,
                                                     0, 0) + blob)
    await w.op("write 5000 B at 70000", WRITE, f,
               RW_IN.pack(fh, 70_000, len(tail), 0, 0, 0, 0) + tail)
    await w.op("getattr f while open", GETATTR, f, bytes(16))
    await w.op("flush", FLUSH, f, struct.pack("<QIIQ", fh, 0, 0, 0))
    await w.op("fsync", FSYNC, f, struct.pack("<QII", fh, 0, 0))
    await w.op("release", RELEASE, f, struct.pack("<QIIQ", fh, 0, 0, 0))
    await w.op("getattr f", GETATTR, f, bytes(16))

    fh = await w.fh("open f rdonly", OPEN, f, struct.pack("<II", os.O_RDONLY, 0))
    await w.op("read all", READ, f, read_in(fh, 0, 1 << 17))
    await w.op("read at eof", READ, f, read_in(fh, 70_000, 10_000))
    await w.op("read past eof", READ, f, read_in(fh, 80_000, 4096))
    await w.op("read bad fh: EBADF", READ, f, read_in(999, 0, 10))
    await w.op("write read-only fh: EBADF", WRITE, f,
               RW_IN.pack(fh, 0, 3, 0, 0, 0, 0) + b"abc")
    await w.op("release rdonly", RELEASE, f, struct.pack("<QIIQ", fh, 0, 0, 0))

    # SETATTR: mode, uid, gid; size; explicit times; times now
    await w.op("setattr mode uid gid", SETATTR, f, setattr_in(
        FATTR_MODE | FATTR_UID | FATTR_GID, mode=0o100600, uid=1000, gid=1000))
    await w.op("setattr size", SETATTR, f, setattr_in(FATTR_SIZE, size=12_345))
    await w.op("setattr times", SETATTR, f, setattr_in(
        FATTR_ATIME | FATTR_MTIME, atime=1_600_000_000, mtime=1_600_000_100,
        atime_ns=250_000_000, mtime_ns=500_000_000))
    await w.op("setattr times now", SETATTR, f, setattr_in(
        FATTR_ATIME | FATTR_MTIME | FATTR_ATIME_NOW | FATTR_MTIME_NOW))
    await w.op("setattr pre-epoch mtime", SETATTR, f, setattr_in(
        FATTR_MTIME, mtime=(1 << 64) - 5))
    await w.op("access owner r", ACCESS, f, struct.pack("<II", 4, 0),
               uid=1000, gid=1000)
    await w.op("access other r: EACCES", ACCESS, f, struct.pack("<II", 4, 0),
               uid=1001, gid=1001)
    fh = await w.fh("open f rdwr", OPEN, f, struct.pack("<II", os.O_RDWR, 0))
    await w.op("overwrite", WRITE, f, RW_IN.pack(fh, 100, 4, 0, 0, 0, 0)
               + b"WXYZ")
    await w.op("read back overwrite", READ, f, read_in(fh, 96, 12))
    await w.op("release rdwr", RELEASE, f, struct.pack("<QIIQ", fh, 0, 0, 0))

    # a directory of seven entries, read in pages
    for name in ("a", "b", "c", "e", "g"):
        reply = await w.op(f"create d/{name}", CREATE, d, create + z(name))
        fh = struct.unpack_from("<Q", reply, OUT_HDR.size + 128)[0]
        await w.op(f"release d/{name}", RELEASE, d,
                   struct.pack("<QIIQ", fh, 0, 0, 0))
    await w.op("mknod d/n", MKNOD, d, struct.pack("<IIII", 0o100640, 0, 0o022, 0)
               + z("n"))
    await w.op("mknod fifo: ENOSYS", MKNOD, d,
               struct.pack("<IIII", statmod.S_IFIFO | 0o644, 0, 0, 0) + z("p"))
    dh = await w.fh("opendir d", OPENDIR, d, struct.pack("<II", 0, 0))
    await w.op("readdir page 1", READDIR, d, read_in(dh, 0, 80))
    await w.op("readdir page 2", READDIR, d, read_in(dh, 3, 80))
    await w.op("readdirplus page 1", READDIRPLUS, d, read_in(dh, 0, 600))
    await w.op("readdirplus page 2", READDIRPLUS, d, read_in(dh, 3, 600))
    await w.op("readdirplus page 3", READDIRPLUS, d, read_in(dh, 6, 600))
    await w.op("readdirplus rewind", READDIRPLUS, d, read_in(dh, 0, 4096))
    await w.op("releasedir", RELEASEDIR, d, struct.pack("<QIIQ", dh, 0, 0, 0))
    await w.op("readdir bad fh: EBADF", READDIR, d, read_in(dh, 0, 4096))
    await w.op("fsyncdir", FSYNCDIR, d, struct.pack("<QII", 0, 0, 0))

    # links and renames
    await w.op("symlink d/ln", SYMLINK, d, z("ln") + z("f"))
    ln = await w.entry("lookup d/ln", LOOKUP, d, z("ln"))
    await w.op("readlink d/ln", READLINK, ln)
    await w.op("link f as /hard", LINK, ROOT, struct.pack("<Q", f) + z("hard"))
    await w.op("getattr f, nlink 2", GETATTR, f, bytes(16))
    await w.op("link of a dir: EPERM", LINK, ROOT, struct.pack("<Q", d)
               + z("dlink"))
    await w.op("rename d/a to /a2", RENAME, d, struct.pack("<Q", ROOT)
               + z("a") + z("a2"))
    await w.op("rename2 noreplace onto c: EEXIST", RENAME2, d,
               struct.pack("<QII", d, 1, 0) + z("b") + z("c"))
    await w.op("rename2 noreplace b to b2", RENAME2, d,
               struct.pack("<QII", d, 1, 0) + z("b") + z("b2"))
    await w.op("rename2 exchange b2 and c", RENAME2, d,
               struct.pack("<QII", d, 2, 0) + z("b2") + z("c"))
    await w.op("rename2 exchange with a missing name: ENOENT", RENAME2, d,
               struct.pack("<QII", d, 2, 0) + z("b2") + z("zz"))
    await w.op("rename2 whiteout: EINVAL", RENAME2, d,
               struct.pack("<QII", d, 4, 0) + z("b2") + z("c"))

    # the t3fs.lock xattr
    lock = b"t3fs.lock\0"
    await w.op("setxattr lock try_lock", SETXATTR, d,
               struct.pack("<II", 8, 0) + lock + b"try_lock")
    await w.op("getxattr lock size probe", GETXATTR, d,
               struct.pack("<II", 0, 0) + lock)
    await w.op("getxattr lock", GETXATTR, d, struct.pack("<II", 4096, 0) + lock)
    await w.op("getxattr lock short: ERANGE", GETXATTR, d,
               struct.pack("<II", 2, 0) + lock)
    await w.op("listxattr probe", LISTXATTR, d, struct.pack("<II", 0, 0))
    await w.op("listxattr", LISTXATTR, d, struct.pack("<II", 256, 0))
    await w.op("setxattr foreign: ENOTSUP", SETXATTR, d,
               struct.pack("<II", 1, 0) + b"user.x\0" + b"x")
    await w.op("getxattr foreign: ENODATA", GETXATTR, d,
               struct.pack("<II", 64, 0) + b"user.x\0")
    await w.op("setxattr lock on a file: ENOTSUP", SETXATTR, f,
               struct.pack("<II", 8, 0) + lock + b"try_lock")
    await w.op("setxattr lock bogus: EINVAL", SETXATTR, d,
               struct.pack("<II", 5, 0) + lock + b"bogus")
    await w.op("removexattr lock", REMOVEXATTR, d, lock)
    await w.op("removexattr foreign: EPERM", REMOVEXATTR, d, b"user.x\0")
    await w.op("removexattr lock on a file: ENOTDIR", REMOVEXATTR, f, lock)
    await w.op("listxattr unlocked", LISTXATTR, d, struct.pack("<II", 256, 0))

    # removals and their errors
    await w.op("unlink /hard", UNLINK, ROOT, z("hard"))
    await w.op("rmdir non-empty d: ENOTEMPTY", RMDIR, ROOT, z("d"))
    await w.op("rmdir of a file: ENOTDIR", RMDIR, d, z("f"))
    await w.op("unlink of a dir: EISDIR", UNLINK, ROOT, z("d"))
    await w.op("unlink missing: ENOENT", UNLINK, d, z("missing"))
    await w.op("lookup below a file: ENOTDIR", LOOKUP, f, z("x"))

    # the /t3fs-virt tree
    await w.op("lookup /t3fs-virt", LOOKUP, ROOT, z("t3fs-virt"))
    vh = await w.fh("opendir /t3fs-virt", OPENDIR, VIRT_DIR,
                    struct.pack("<II", 0, 0))
    await w.op("readdir /t3fs-virt", READDIR, VIRT_DIR, read_in(vh, 0, 4096))
    await w.op("releasedir /t3fs-virt", RELEASEDIR, VIRT_DIR,
               struct.pack("<QIIQ", vh, 0, 0, 0))
    await w.op("lookup get-conf", LOOKUP, VIRT_DIR, z("get-conf"))
    await w.op("lookup nonesuch: ENOENT", LOOKUP, VIRT_DIR, z("nonesuch"))
    gh = await w.fh("opendir get-conf", OPENDIR, GETCONF_DIR,
                    struct.pack("<II", 0, 0))
    await w.op("readdirplus get-conf", READDIRPLUS, GETCONF_DIR,
               read_in(gh, 0, 4096))
    await w.op("releasedir get-conf", RELEASEDIR, GETCONF_DIR,
               struct.pack("<QIIQ", gh, 0, 0, 0))
    key = await w.entry("lookup get-conf/attr_timeout", LOOKUP, GETCONF_DIR,
                        z("attr_timeout"))
    assert key == KEY_BASE + port_ucfg.USER_KEYS.index("attr_timeout")
    await w.op("readlink attr_timeout", READLINK, key)
    await w.op("set-conf attr_timeout 0.25", SYMLINK, SETCONF_DIR,
               z("attr_timeout") + z("0.25"))
    await w.op("readlink attr_timeout after", READLINK, key)
    await w.op("getattr root, 0.25 s attr timeout", GETATTR, ROOT, bytes(16))
    await w.op("set-conf unknown key: ENOENT", SYMLINK, SETCONF_DIR,
               z("nonsense") + z("1"))
    await w.op("set-conf bad value: EINVAL", SYMLINK, SETCONF_DIR,
               z("entry_timeout") + z("-1"))
    await w.op("lookup set-conf/readonly: ENOENT", LOOKUP, SETCONF_DIR,
               z("readonly"))
    await w.op("mkdir in the tree: EACCES", MKDIR, VIRT_DIR,
               struct.pack("<II", 0o755, 0) + z("x"))
    await w.op("getxattr in the tree: ENOTSUP", GETXATTR, VIRT_DIR,
               struct.pack("<II", 64, 0) + lock)
    await w.op("removexattr in the tree: EPERM", REMOVEXATTR, VIRT_DIR, lock)
    await w.op("access in the tree", ACCESS, GETCONF_DIR, struct.pack("<II", 4, 0))
    await w.op("statfs in the tree", STATFS, VIRT_DIR)

    # rm-rf through the tree
    tree = await w.entry("mkdir /tree", MKDIR, ROOT,
                         struct.pack("<II", 0o755, 0) + z("tree"))
    deep = await w.entry("mkdir /tree/deep", MKDIR, tree,
                         struct.pack("<II", 0o700, 0) + z("deep"))
    reply = await w.op("create /tree/deep/x", CREATE, deep, create + z("x"))
    fh = struct.unpack_from("<Q", reply, OUT_HDR.size + 128)[0]
    await w.op("release /tree/deep/x", RELEASE, deep,
               struct.pack("<QIIQ", fh, 0, 0, 0))
    await w.op("rm-rf /tree", SYMLINK, RMRF_DIR, z("job1") + z("/tree"))
    await w.op("lookup /tree after rm-rf: ENOENT", LOOKUP, ROOT, z("tree"))
    await w.op("rm-rf of the root: EPERM", SYMLINK, RMRF_DIR, z("job2") + z("/"))
    await w.op("rm-rf relative: EINVAL", SYMLINK, RMRF_DIR, z("job3") + z("rel"))

    # a readonly user (uid 1000's own override), and mode-bit denials
    await w.op("set-conf readonly 1 as uid 1000", SYMLINK, SETCONF_DIR,
               z("readonly") + z("1"), uid=1000, gid=1000)
    await w.op("get-conf readonly as uid 1000", READLINK,
               KEY_BASE + port_ucfg.USER_KEYS.index("readonly"),
               uid=1000, gid=1000)
    await w.op("mkdir as readonly uid: EROFS", MKDIR, ROOT,
               struct.pack("<II", 0o755, 0) + z("ro"), uid=1000, gid=1000)
    await w.op("open for write as readonly uid: EROFS", OPEN, f,
               struct.pack("<II", os.O_WRONLY, 0), uid=1000, gid=1000)
    await w.op("rm-rf as readonly uid: EROFS", SYMLINK, RMRF_DIR,
               z("job4") + z("/d"), uid=1000, gid=1000)
    await w.op("open for read as readonly uid", OPEN, f,
               struct.pack("<II", os.O_RDONLY, 0), uid=1000, gid=1000)
    await w.op("mkdir in / as uid 1001: EACCES", MKDIR, ROOT,
               struct.pack("<II", 0o755, 0) + z("nope"), uid=1001, gid=1001)
    await w.op("open 0o600 file as uid 1001: EACCES", OPEN, f,
               struct.pack("<II", os.O_RDONLY, 0), uid=1001, gid=1001)
    await w.op("lookup in 0o700 dir as uid 1001", LOOKUP, ROOT, z("d"),
               uid=1001, gid=1001)
    await w.op("mkdir as root while uid 1000 is readonly", MKDIR, ROOT,
               struct.pack("<II", 0o700, 0) + z("rw"))

    # no reply, and what the mount does not implement
    await w.op("forget", FORGET, f, struct.pack("<Q", 1))
    await w.op("interrupt", INTERRUPT, 0, struct.pack("<Q", 5))
    await w.op("unknown opcode: ENOSYS", 99, ROOT)
    await w.op("destroy", DESTROY, 0)


def pin_time(monkeypatch) -> None:
    """time.time is read through the module in both packages' meta, fuse
    and user_config code, so patching the module pins all of them."""
    monkeypatch.setattr(time, "time", lambda: T0)


async def replies_of(cluster, kernel) -> list[tuple[str, bytes, bytes | None]]:
    await cluster.start()
    try:
        cluster.mc.client_id = CLIENT_ID
        mount = kernel.FuseKernelMount(cluster.mc, cluster.sc,
                                       "/t3fs-fuse-diff/unmounted")
        w = Wire(mount)
        await request_sequence(w)
        return w.steps
    finally:
        await cluster.stop()


def test_reply_frames_equal_byte_for_byte(monkeypatch):
    # the /t3fs-virt ids and keys the frames address are the reference's
    for name in ("VIRT_BASE", "VIRT_DIR", "RMRF_DIR", "GETCONF_DIR",
                 "SETCONF_DIR", "KEY_BASE", "SETKEY_BASE", "VIRT_NAME",
                 "USER_KEYS", "MAX_TIMEOUT_S"):
        assert getattr(port_ucfg, name) == getattr(ref_ucfg, name), name
    pin_time(monkeypatch)
    ref = asyncio.run(replies_of(
        RefCluster(num_nodes=1, replicas=1, with_meta=True,
                   heartbeat_timeout_s=60.0), ref_kernel))
    port = asyncio.run(replies_of(
        PortCluster(num_nodes=1, replicas=1, with_meta=True,
                    heartbeat_timeout_s=60.0, checksum_backend="cpu"),
        port_kernel))
    assert len(ref) == len(port) > 100
    for (name, msg_r, rep_r), (_n, msg_p, rep_p) in zip(ref, port):
        assert msg_p == msg_r, f"{name}: the request frames differ"
        if name.startswith("init"):
            # the one masked field: the port adds FUSE_BIG_WRITES
            (flags_r,) = struct.unpack_from("<I", rep_r, INIT_FLAGS_AT)
            (flags_p,) = struct.unpack_from("<I", rep_p, INIT_FLAGS_AT)
            assert flags_r == (0 if "gVisor" in name else (1 << 13) | (1 << 14))
            assert flags_p == flags_r | FUSE_BIG_WRITES
            at = INIT_FLAGS_AT
            rep_p = rep_p[:at] + rep_r[at:at + 4] + rep_p[at + 4:]
        assert rep_p == rep_r, (name, rep_r, rep_p)
    # the sequence reached what it names: each errno at least once, and the
    # ops that must not reply did not
    errors = {-OUT_HDR.unpack_from(r)[1] for _n, _m, r in port if r}
    for e in (errno.ENOENT, errno.EEXIST, errno.ENOTEMPTY, errno.EACCES,
              errno.EROFS, errno.EBADF, errno.ENOSYS, errno.EPERM,
              errno.EINVAL, errno.ENOTSUP, errno.ENODATA, errno.ERANGE,
              errno.ENOTDIR, errno.EISDIR):
        assert e in errors, errno.errorcode[e]
    no_reply = [n for n, _m, r in port if r is None]
    assert no_reply == ["forget", "interrupt"]
    frames = {n: r for n, _m, r in port if r}
    data = {n: r[OUT_HDR.size:] for n, r in frames.items()}
    assert Wire.error(frames["read all"]) == 0
    assert len(data["read all"]) == 75_000
    assert json.loads(data["getxattr lock"]) == {"client": CLIENT_ID}
    assert data["readlink attr_timeout after"] == b"0.25"


# --- (b) POSIX through two real mounts ---------------------------------------


async def write_sizes_on(cluster, kernel, mnt: str) -> tuple[dict, bool]:
    """The WRITE payload sizes one 1 MiB write(2) reaches the storage client
    with through a mount of `kernel`, and whether it reads back."""
    await cluster.start()
    sizes: dict[int, int] = {}
    try:
        os.makedirs(mnt)
        write_file_range = cluster.sc.write_file_range

        async def counted(layout, inode, off, data):
            sizes[len(data)] = sizes.get(len(data), 0) + 1
            return await write_file_range(layout, inode, off, data)
        cluster.sc.write_file_range = counted
        fuse = kernel.FuseKernelMount(cluster.mc, cluster.sc, mnt)
        blob = np.random.default_rng(SEED + 2).integers(
            0, 256, 1 << 20, dtype=np.uint8).tobytes()

        def posix():
            fd = os.open(f"{mnt}/w", os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                assert os.write(fd, blob) == len(blob)
            finally:
                os.close(fd)
            with open(f"{mnt}/w", "rb") as f:
                return f.read() == blob
        try:
            await fuse.mount()
            same = await asyncio.to_thread(posix)
        finally:
            await fuse.unmount()
        return sizes, same
    finally:
        await cluster.stop()


@needs_fuse
def test_big_writes_where_the_reference_sends_4k(fuse_tmp):
    """The deliberate difference, pinned in both packages: the reference's
    INIT reply leaves FUSE_BIG_WRITES out, so its kernel sends one 1 MiB
    write(2) as 256 WRITEs of 4 KiB (each a write_file_range, under the
    storage nodes' 64 KiB device cutoff); the port's accepts it, and the
    same write arrives as 8 WRITEs of max_write = 128 KiB."""
    ref = asyncio.run(write_sizes_on(
        RefCluster(num_nodes=1, replicas=1, with_meta=True,
                   heartbeat_timeout_s=60.0), ref_kernel,
        os.path.join(fuse_tmp, "ref")))
    port = asyncio.run(write_sizes_on(
        PortCluster(num_nodes=1, replicas=1, with_meta=True,
                    heartbeat_timeout_s=60.0, checksum_backend="cpu"),
        port_kernel, os.path.join(fuse_tmp, "port")))
    assert ref == ({4096: 256}, True)
    assert port == ({1 << 17: 8}, True)

_libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)


def _renameat2(old: str, new: str, flags: int) -> int:
    r = _libc.renameat2(-100, old.encode(), -100, new.encode(), flags)
    if r != 0:
        e = ctypes.get_errno()
        raise OSError(e, os.strerror(e))
    return 0


def _stat(p: str) -> tuple:
    st = os.lstat(p)
    return (st.st_mode, st.st_size, st.st_nlink, st.st_uid, st.st_gid,
            st.st_ino)


def posix_script(mnt: str) -> list[tuple]:
    """One script of syscalls on a mount; each step's result or errno."""
    out: list[tuple] = []

    def step(name, fn):
        try:
            out.append((name, "ok", fn()))
        except OSError as e:
            out.append((name, "err", errno.errorcode.get(e.errno, e.errno)))

    def write(p, data, mode="wb"):
        with open(p, mode) as f:
            return f.write(data)

    def read(p, off=0, n=-1):
        with open(p, "rb") as f:
            f.seek(off)
            return f.read(n)

    rng = np.random.default_rng(SEED + 1)
    blob = rng.integers(0, 256, 150 * 1024, dtype=np.uint8).tobytes()
    virt = f"{mnt}/t3fs-virt"

    # the reference's round trip
    step("mkdir dir", lambda: os.mkdir(f"{mnt}/dir"))
    step("write hello", lambda: write(f"{mnt}/dir/hello.txt",
                                      b"hello t3fs over real fuse\n"))
    step("listdir /", lambda: sorted(os.listdir(mnt)))
    step("read hello", lambda: read(f"{mnt}/dir/hello.txt"))
    step("stat hello", lambda: _stat(f"{mnt}/dir/hello.txt"))
    step("rename hello", lambda: os.rename(f"{mnt}/dir/hello.txt",
                                           f"{mnt}/dir/renamed.txt"))
    step("symlink", lambda: os.symlink("renamed.txt", f"{mnt}/dir/link"))
    step("readlink", lambda: os.readlink(f"{mnt}/dir/link"))
    step("read through link", lambda: read(f"{mnt}/dir/link"))
    step("lstat link", lambda: _stat(f"{mnt}/dir/link"))

    # dd-style I/O over many chunks, a random read and a truncate
    def dd():
        with open(f"{mnt}/big.bin", "wb") as f:
            for off in range(0, len(blob), 32 * 1024):
                f.write(blob[off:off + 32 * 1024])
    step("dd write", dd)
    step("stat big", lambda: _stat(f"{mnt}/big.bin"))
    step("read big", lambda: read(f"{mnt}/big.bin") == blob)
    step("random read", lambda: read(f"{mnt}/big.bin", 100_000, 5000)
         == blob[100_000:105_000])
    step("truncate", lambda: os.truncate(f"{mnt}/big.bin", 10_000))
    step("stat truncated", lambda: _stat(f"{mnt}/big.bin"))
    step("read truncated", lambda: read(f"{mnt}/big.bin") == blob[:10_000])
    step("append", lambda: write(f"{mnt}/big.bin", b"tail", "ab"))
    step("read appended tail", lambda: read(f"{mnt}/big.bin", 9_998))

    # chmod, chown, explicit times
    step("chmod", lambda: os.chmod(f"{mnt}/big.bin", 0o640))
    step("chown", lambda: os.chown(f"{mnt}/big.bin", 1234, 5678))
    step("stat after chmod chown", lambda: _stat(f"{mnt}/big.bin"))
    step("utime explicit", lambda: os.utime(f"{mnt}/big.bin",
                                            (1_600_000_000, 1_600_000_100)))
    step("explicit times", lambda: (int(os.stat(f"{mnt}/big.bin").st_atime),
                                    int(os.stat(f"{mnt}/big.bin").st_mtime)))
    step("utime now", lambda: os.utime(f"{mnt}/big.bin"))

    # a hardlink
    step("write a", lambda: write(f"{mnt}/a", b"linked-data"))
    step("link a b", lambda: os.link(f"{mnt}/a", f"{mnt}/b"))
    step("stat a", lambda: _stat(f"{mnt}/a"))
    step("stat b", lambda: _stat(f"{mnt}/b"))
    step("unlink a", lambda: os.unlink(f"{mnt}/a"))
    step("read b", lambda: read(f"{mnt}/b"))
    step("stat b after", lambda: _stat(f"{mnt}/b"))
    step("link a dir", lambda: os.link(f"{mnt}/dir", f"{mnt}/dirln"))

    # renameat2's flags
    step("write x", lambda: write(f"{mnt}/x", b"X"))
    step("noreplace onto b", lambda: _renameat2(f"{mnt}/x", f"{mnt}/b", 1))
    step("noreplace to c", lambda: _renameat2(f"{mnt}/x", f"{mnt}/c", 1))
    step("exchange b c", lambda: _renameat2(f"{mnt}/b", f"{mnt}/c", 2))
    step("read b, c", lambda: (read(f"{mnt}/b"), read(f"{mnt}/c")))
    step("exchange with missing", lambda: _renameat2(f"{mnt}/b", f"{mnt}/zz", 2))
    step("exchange dir and file", lambda: _renameat2(f"{mnt}/dir", f"{mnt}/b", 2))
    step("listdir / after renames", lambda: sorted(os.listdir(mnt)))

    # xattrs: the t3fs.lock directory lock
    step("mkdir locked", lambda: os.mkdir(f"{mnt}/locked"))
    step("setxattr foreign", lambda: os.setxattr(f"{mnt}/locked", "user.foo",
                                                 b"x"))
    step("getxattr foreign", lambda: os.getxattr(f"{mnt}/locked", "user.foo"))
    step("listxattr unlocked", lambda: os.listxattr(f"{mnt}/locked"))
    step("try_lock", lambda: os.setxattr(f"{mnt}/locked", "t3fs.lock",
                                         b"try_lock"))
    step("listxattr locked", lambda: os.listxattr(f"{mnt}/locked"))
    step("getxattr holder", lambda: os.getxattr(f"{mnt}/locked", "t3fs.lock"))
    step("create under own lock", lambda: write(f"{mnt}/locked/mine", b""))
    step("bogus action", lambda: os.setxattr(f"{mnt}/locked", "t3fs.lock",
                                             b"bogus"))
    step("lock a file", lambda: os.setxattr(f"{mnt}/c", "t3fs.lock",
                                            b"try_lock"))
    step("removexattr clears", lambda: os.removexattr(f"{mnt}/locked",
                                                      "t3fs.lock"))
    step("listxattr cleared", lambda: os.listxattr(f"{mnt}/locked"))

    # the /t3fs-virt tree and the user config
    step("listdir virt", lambda: sorted(os.listdir(virt)))
    step("listdir get-conf", lambda: sorted(os.listdir(f"{virt}/get-conf")))
    step("readlink readonly", lambda: os.readlink(f"{virt}/get-conf/readonly"))
    step("readlink attr_timeout",
         lambda: os.readlink(f"{virt}/get-conf/attr_timeout"))
    step("set attr_timeout", lambda: os.symlink(
        "0.25", f"{virt}/set-conf/attr_timeout"))
    step("readlink attr_timeout after",
         lambda: os.readlink(f"{virt}/get-conf/attr_timeout"))
    step("set unknown key", lambda: os.symlink("1", f"{virt}/set-conf/nonsense"))
    step("makedirs tree", lambda: os.makedirs(f"{mnt}/tree/t/deep"))
    step("write in tree", lambda: write(f"{mnt}/tree/t/deep/f", b"x" * 1000))
    step("rm-rf tree", lambda: os.symlink(f"{mnt}/tree", f"{virt}/rm-rf/job1"))
    step("tree gone", lambda: os.path.exists(f"{mnt}/tree"))
    step("readonly on", lambda: os.symlink("1", f"{virt}/set-conf/readonly"))
    step("write when readonly", lambda: write(f"{mnt}/nope", b"no"))
    step("mkdir when readonly", lambda: os.mkdir(f"{mnt}/nope.d"))
    step("readonly off", lambda: os.symlink("0", f"{virt}/set-conf/readonly"))
    step("write after", lambda: write(f"{mnt}/yes", b"ok"))

    # errors and statfs
    step("mkdir existing", lambda: os.mkdir(f"{mnt}/locked"))
    step("rmdir non-empty", lambda: os.rmdir(f"{mnt}/locked"))
    step("open missing", lambda: read(f"{mnt}/missing"))
    step("rmdir a file", lambda: os.rmdir(f"{mnt}/c"))
    step("statvfs", lambda: tuple(os.statvfs(mnt))[:9])
    step("access public r", lambda: os.access(f"{mnt}/yes", os.R_OK))

    # cleanup to an empty root
    for p in ("locked/mine", "yes", "c", "big.bin", "b/renamed.txt", "b/link"):
        step(f"unlink {p}", lambda p=p: os.unlink(f"{mnt}/{p}"))
    for p in ("locked", "b"):
        step(f"rmdir {p}", lambda p=p: os.rmdir(f"{mnt}/{p}"))
    step("unlink dir (a file now)", lambda: os.unlink(f"{mnt}/dir"))
    step("listdir / at the end", lambda: sorted(os.listdir(mnt)))
    return out


async def posix_on(cluster, kernel, mnt: str) -> list[tuple]:
    await cluster.start()
    try:
        cluster.mc.client_id = CLIENT_ID
        os.makedirs(mnt)
        fuse = kernel.FuseKernelMount(cluster.mc, cluster.sc, mnt)
        try:
            await fuse.mount()
            return await asyncio.to_thread(posix_script, mnt)
        finally:
            await fuse.unmount()
    finally:
        await cluster.stop()


@needs_fuse
def test_posix_script_equal_through_both_mounts(fuse_tmp):
    ref = asyncio.run(posix_on(
        RefCluster(num_nodes=3, replicas=3, with_meta=True,
                   heartbeat_timeout_s=60.0), ref_kernel,
        os.path.join(fuse_tmp, "ref")))
    port = asyncio.run(posix_on(
        PortCluster(num_nodes=3, replicas=3, with_meta=True,
                    heartbeat_timeout_s=60.0, checksum_backend="cpu"),
        port_kernel, os.path.join(fuse_tmp, "port")))
    assert [s[0] for s in port] == [s[0] for s in ref]
    for r, p in zip(ref, port):
        assert p == r, (r, p)
    res = {name: (kind, val) for name, kind, val in port}
    # the script did what it names, in both
    assert res["read big"] == ("ok", True)
    assert res["random read"] == ("ok", True)
    assert res["read truncated"] == ("ok", True)
    assert res["explicit times"] == ("ok", (1_600_000_000, 1_600_000_100))
    assert res["noreplace onto b"] == ("err", "EEXIST")
    assert res["exchange with missing"] == ("err", "ENOENT")
    assert res["link a dir"] == ("err", "EPERM")
    assert res["setxattr foreign"] == ("err", "ENOTSUP")
    assert res["getxattr holder"][0] == "ok"
    assert json.loads(res["getxattr holder"][1]) == {"client": CLIENT_ID}
    assert res["write when readonly"] == ("err", "EROFS")
    assert res["tree gone"] == ("ok", False)
    assert res["listdir / at the end"] == ("ok", [])
    assert sum(1 for _n, kind, _v in port if kind == "ok") > 60
