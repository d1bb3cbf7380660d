"""USRBIO app-side API: shared-memory I/O rings + iov buffers.

Reference analog: src/lib/api/hf3fs_usrbio.h:59-170 (hf3fs_iovcreate,
hf3fs_iorcreate4, hf3fs_reg_fd, hf3fs_prep_io, hf3fs_submit_ios,
hf3fs_wait_for_ios) and the python wrapper hf3fs_fuse/io.py (make_iovec /
make_ioring / submit).  The daemon side lives in t3fs_torch/fuse/ring_worker.py.

Zero-copy: the iov is a POSIX shm segment mapped by both the app and the
daemon; reads land directly in it, writes are consumed from it.

The port of t3fs/lib/usrbio.py, bound to the port's own host library
(csrc/usrbio.cpp, built by ops/_build.host_library into
t3fs_torch/_build/).  The SQE and CQE structs and the shm ring layout are
the reference's byte for byte, so an app of either package talks to a
daemon of the other.
"""

from __future__ import annotations

import ctypes as C
from dataclasses import dataclass

import numpy as np

OP_READ = 0
OP_WRITE = 1


class CSqe(C.Structure):
    _fields_ = [("userdata", C.c_uint64), ("ident", C.c_uint64),
                ("iov_off", C.c_uint64), ("len", C.c_uint64),
                ("file_off", C.c_uint64), ("op", C.c_uint32),
                ("flags", C.c_uint32)]


class CCqe(C.Structure):
    _fields_ = [("userdata", C.c_uint64), ("result", C.c_int64),
                ("status", C.c_uint32), ("pad", C.c_uint32)]


def _bind():
    from t3fs_torch.ops._build import host_library

    lib = host_library()
    lib.t3fs_iov_create.restype = C.c_void_p
    lib.t3fs_iov_create.argtypes = [C.c_char_p, C.c_uint64]
    lib.t3fs_iov_open.restype = C.c_void_p
    lib.t3fs_iov_open.argtypes = [C.c_char_p, C.c_uint64]
    lib.t3fs_iov_destroy.argtypes = [C.c_char_p, C.c_void_p, C.c_uint64]
    lib.t3fs_iov_stat.restype = C.c_uint64
    lib.t3fs_iov_stat.argtypes = [C.c_char_p]
    lib.t3fs_iov_unmap.argtypes = [C.c_void_p, C.c_uint64]
    lib.t3fs_ior_create.restype = C.c_void_p
    lib.t3fs_ior_create.argtypes = [C.c_char_p, C.c_uint32, C.c_char_p]
    lib.t3fs_ior_open.restype = C.c_void_p
    lib.t3fs_ior_open.argtypes = [C.c_char_p]
    lib.t3fs_ior_destroy.argtypes = [C.c_void_p]
    lib.t3fs_ior_iov_name.restype = C.c_char_p
    lib.t3fs_ior_iov_name.argtypes = [C.c_void_p]
    lib.t3fs_ior_entries.restype = C.c_uint32
    lib.t3fs_ior_entries.argtypes = [C.c_void_p]
    lib.t3fs_ior_prep.restype = C.c_int64
    lib.t3fs_ior_prep.argtypes = [C.c_void_p, C.c_uint32, C.c_uint64,
                                  C.c_uint64, C.c_uint64, C.c_uint64,
                                  C.c_uint64]
    lib.t3fs_ior_submit.argtypes = [C.c_void_p, C.c_uint32]
    lib.t3fs_ior_pop_sqe.restype = C.c_int
    lib.t3fs_ior_pop_sqe.argtypes = [C.c_void_p, C.POINTER(CSqe), C.c_int]
    lib.t3fs_ior_pop_sqes.restype = C.c_int64
    lib.t3fs_ior_pop_sqes.argtypes = [C.c_void_p, C.POINTER(CSqe),
                                      C.c_uint32, C.c_int]
    lib.t3fs_ior_complete.restype = C.c_int
    lib.t3fs_ior_complete.argtypes = [C.c_void_p, C.c_uint64, C.c_int64,
                                      C.c_uint32]
    lib.t3fs_ior_complete_many.restype = C.c_int64
    lib.t3fs_ior_complete_many.argtypes = [C.c_void_p, C.POINTER(CCqe),
                                           C.c_uint32]
    lib.t3fs_ior_wait.restype = C.c_int64
    lib.t3fs_ior_wait.argtypes = [C.c_void_p, C.POINTER(CCqe), C.c_uint32,
                                  C.c_uint32, C.c_int]
    return lib


_libholder: list = []


def _lib():
    if not _libholder:
        _libholder.append(_bind())
    return _libholder[0]


class IoVec:
    """Shared data buffer (hf3fs_iov analog)."""

    def __init__(self, name: str, size: int = 0, create: bool = True):
        self.name = name
        self._create = create
        if not create:
            # always map the segment's REAL size (reference iovopen fstats
            # the shm): guessing small breaks valid iov_off, guessing large
            # SIGBUSes past the end
            actual = _lib().t3fs_iov_stat(name.encode())
            if actual == 0:
                raise OSError(f"iov open failed: {name} (no such segment)")
            size = actual
        elif size <= 0:
            raise ValueError("iov create needs a positive size")
        self.size = size
        fn = _lib().t3fs_iov_create if create else _lib().t3fs_iov_open
        self._base = fn(name.encode(), size)
        if not self._base:
            raise OSError(f"iov {'create' if create else 'open'} failed: {name}")
        self.buf = (C.c_uint8 * size).from_address(self._base)
        self.view = np.frombuffer(self.buf, dtype=np.uint8)

    @property
    def addr(self) -> int:
        """Raw mapping address — valid until close().  The storage node's
        inline ring reads pread straight to `addr + iov_off` (no per-IO
        buffer wrapping)."""
        return self._base or 0

    def write_at(self, off: int, data: bytes) -> None:
        self.view[off:off + len(data)] = np.frombuffer(data, dtype=np.uint8)

    def read_at(self, off: int, length: int) -> bytes:
        return self.view[off:off + length].tobytes()

    def close(self, unlink: bool | None = None) -> None:
        if self._base:
            if unlink if unlink is not None else self._create:
                _lib().t3fs_iov_destroy(self.name.encode(), self._base,
                                        self.size)
            else:
                _lib().t3fs_iov_unmap(self._base, self.size)
            self._base = None


@dataclass
class Completion:
    userdata: int
    result: int
    status: int


class IoRing:
    """Submission/completion ring (hf3fs_ior analog)."""

    def __init__(self, name: str, entries: int = 256,
                 iov: IoVec | None = None, create: bool = True):
        self.name = name
        self._create = create
        if create:
            assert iov is not None, "creating a ring requires its iov"
            self._h = _lib().t3fs_ior_create(name.encode(), entries,
                                             iov.name.encode())
        else:
            self._h = _lib().t3fs_ior_open(name.encode())
        if not self._h:
            raise OSError(f"ior {'create' if create else 'open'} failed: {name}")
        self.iov = iov
        self.entries = _lib().t3fs_ior_entries(self._h)
        self._pending = 0

    @property
    def iov_name(self) -> str:
        return _lib().t3fs_ior_iov_name(self._h).decode()

    # -- app side --

    def prep_io(self, is_read: bool, ident: int, iov_off: int, length: int,
                file_off: int, userdata: int = 0) -> int:
        slot = _lib().t3fs_ior_prep(self._h, OP_READ if is_read else OP_WRITE,
                                    ident, iov_off, length, file_off, userdata)
        if slot < 0:
            raise BufferError("ring full")
        self._pending += 1
        return int(slot)

    def submit_ios(self) -> None:
        n, self._pending = self._pending, 0
        if n:
            _lib().t3fs_ior_submit(self._h, n)

    def wait_for_ios(self, max_n: int = 64, min_n: int = 1,
                     timeout_ms: int = -1) -> list[Completion]:
        arr = (CCqe * max_n)()
        got = _lib().t3fs_ior_wait(self._h, arr, max_n, min_n, timeout_ms)
        return [Completion(arr[i].userdata, arr[i].result, arr[i].status)
                for i in range(got)]

    # -- daemon side --

    def pop_sqe(self, timeout_ms: int = 100) -> CSqe | None:
        sqe = CSqe()
        r = _lib().t3fs_ior_pop_sqe(self._h, C.byref(sqe), timeout_ms)
        return sqe if r == 1 else None

    def pop_sqes(self, max_n: int = 64,
                 timeout_ms: int = 100) -> list[CSqe]:
        """Batched pop: one blocking wait for the first sqe, then drain
        the rest of the burst without further syscalls — one library
        call per submission wave instead of one per sqe."""
        arr = (CSqe * max_n)()
        got = _lib().t3fs_ior_pop_sqes(self._h, arr, max_n, timeout_ms)
        return [arr[i] for i in range(got)] if got > 0 else []

    def complete(self, userdata: int, result: int, status: int = 0) -> None:
        _lib().t3fs_ior_complete(self._h, userdata, result, status)

    def complete_many(self,
                      cqes: list[tuple[int, int, int]]) -> None:
        """Batched complete: (userdata, result, status) triples pushed
        under one cq mutex acquisition, one library call per wave."""
        n = len(cqes)
        if not n:
            return
        arr = (CCqe * n)()
        for i, (u, res, st) in enumerate(cqes):
            arr[i].userdata, arr[i].result, arr[i].status = u, res, st
        _lib().t3fs_ior_complete_many(self._h, arr, n)

    def close(self) -> None:
        if self._h:
            _lib().t3fs_ior_destroy(self._h)
            self._h = None


def reg_fd(fh) -> int:
    """Register an open VFS FileHandle for ring I/O; the returned ident goes
    into prep_io (reference hf3fs_reg_fd — there the fd maps through the FUSE
    inode table; here the ident IS the inode id)."""
    return fh.inode.inode_id
