"""AioReadWorker: asyncio front-end for the native io_uring read engine.

Reference analog: src/storage/aio/AioReadWorker.{h,cc} — dedicated threads
each running an io_uring completion loop, consuming read jobs enqueued by
the RPC handlers so disk reads never run on (or block) the RPC executor.
t3fs shape: the event loop preps+submits SQEs directly (two cheap
syscalls), ONE reaper thread blocks in io_uring_enter(GETEVENTS) and posts
completions back via call_soon_threadsafe.  Buffers are caller-owned
bytearrays pinned for the syscall's duration.

Falls back cleanly: ``AioReadWorker.available()`` is False when the kernel
lacks io_uring, or a container's seccomp filter refuses io_uring_setup (the
storage service then keeps its thread-pool path).

The port of t3fs/storage/aio.py over the port's own library
(t3fs_torch/csrc/aio_reader.cpp, built with the chunk engine into one library
by ops/_build.py's host_library).
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import threading

log = logging.getLogger("t3fs_torch.storage.aio")

_SHUTDOWN = (1 << 64) - 1


class _Cqe(ctypes.Structure):
    _fields_ = [("user_data", ctypes.c_uint64),
                ("res", ctypes.c_int32),
                ("_pad", ctypes.c_int32)]


def _lib():
    from t3fs_torch.ops._build import host_library
    lib = host_library()
    lib.t3fs_aio_create.restype = ctypes.c_void_p
    lib.t3fs_aio_create.argtypes = [ctypes.c_uint]
    lib.t3fs_aio_destroy.argtypes = [ctypes.c_void_p]
    lib.t3fs_aio_prep_read.restype = ctypes.c_int
    lib.t3fs_aio_prep_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_uint64]
    lib.t3fs_aio_prep_nop.restype = ctypes.c_int
    lib.t3fs_aio_prep_nop.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.t3fs_aio_submit.restype = ctypes.c_int
    lib.t3fs_aio_submit.argtypes = [ctypes.c_void_p]
    lib.t3fs_aio_wait.restype = ctypes.c_int
    lib.t3fs_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                  ctypes.POINTER(_Cqe), ctypes.c_uint]
    return lib


class AioReadWorker:
    """One io_uring + one reaper thread; submit_read awaits completion."""

    def __init__(self, depth: int = 256):
        self.lib = _lib()
        self.ring = self.lib.t3fs_aio_create(depth)
        if not self.ring:
            raise OSError("io_uring_setup failed (kernel support missing?)")
        self.depth = depth
        self._loop: asyncio.AbstractEventLoop | None = None
        self._next_token = 1
        self._inflight: dict[int, tuple[asyncio.Future, object]] = {}
        self._stopped = False
        self._closing = False
        self._thread = threading.Thread(target=self._reap_loop, daemon=True,
                                        name="t3fs-aio-reaper")
        self.completed = 0

    @staticmethod
    def available() -> bool:
        try:
            lib = _lib()
            ring = lib.t3fs_aio_create(8)
            if not ring:
                return False
            lib.t3fs_aio_destroy(ring)
            return True
        except Exception:
            return False

    def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._thread.start()

    async def submit_read(self, fd: int, offset: int, length: int) -> bytes:
        """pread(fd, offset, length) through the ring; returns the bytes
        (short reads surface short — callers decide if that's an error)."""
        assert self._loop is not None, "start() first"
        if self._closing or self._stopped or self.ring is None:
            raise OSError("aio worker closed")
        buf = ctypes.create_string_buffer(length)   # pinned until CQE
        fut: asyncio.Future = self._loop.create_future()
        token = self._next_token
        self._next_token = (self._next_token + 1) % ((1 << 63))
        self._inflight[token] = (fut, buf)
        r = self.lib.t3fs_aio_prep_read(self.ring, fd, offset, length,
                                        buf, token)
        if r == -11:                                # -EAGAIN: SQ full
            self._inflight.pop(token, None)
            raise BlockingIOError("aio SQ full")
        s = self.lib.t3fs_aio_submit(self.ring)
        if s < 0:
            # the SQE stays queued on the C side (never abandoned) and the
            # entry stays in _inflight so `buf` outlives a late kernel
            # completion — a later submit may still push it through
            raise OSError(-s, "io_uring_enter(submit)")
        res = await fut
        if res < 0:
            raise OSError(-res, f"aio pread fd={fd} off={offset}")
        return buf.raw[:res]

    def _reap_loop(self) -> None:
        out = (_Cqe * 64)()
        while not self._stopped:
            n = self.lib.t3fs_aio_wait(self.ring, 1, out, 64)
            if n < 0:
                if -n == 4:                         # EINTR
                    continue
                log.error("aio wait failed: errno %d — disabling worker",
                          -n)
                # fail everyone and mark dead; submit_read raises from now
                # on and read_aio self-heals onto the thread pipeline
                self._stopped = True
                if self._loop is not None:
                    self._loop.call_soon_threadsafe(self._fail_all,
                                                    OSError(-n, "aio wait"))
                return
            for i in range(n):
                token, res = out[i].user_data, out[i].res
                if token == _SHUTDOWN:
                    self._stopped = True
                    continue
                self.completed += 1
                if self._loop is not None:
                    self._loop.call_soon_threadsafe(
                        self._resolve, token, res)

    def _fail_all(self, exc: BaseException) -> None:
        for token, (fut, _b) in list(self._inflight.items()):
            if not fut.done():
                fut.set_exception(exc)
        self._inflight.clear()

    def _resolve(self, token: int, res: int) -> None:
        entry = self._inflight.pop(token, None)
        if entry is None:
            return
        fut, _buf = entry
        if not fut.done():
            fut.set_result(res)

    async def close(self) -> None:
        if self.ring is None:
            return
        self._closing = True    # reject new submits; reaper keeps reaping
        # drain: kernel completions may still be DMA-writing into pinned
        # buffers; destroying the ring (munmap) under them is a
        # use-after-free.  Let the live reaper resolve in-flight CQEs.
        for _ in range(100):
            if not self._inflight:
                break
            await asyncio.sleep(0.01)
        if not self._stopped and self._thread.is_alive():
            self.lib.t3fs_aio_prep_nop(self.ring, _SHUTDOWN)
            self.lib.t3fs_aio_submit(self.ring)
        await asyncio.to_thread(self._thread.join, 5.0)
        self._stopped = True
        self._fail_all(OSError("aio worker closed"))
        self.lib.t3fs_aio_destroy(self.ring)
        self.ring = None
