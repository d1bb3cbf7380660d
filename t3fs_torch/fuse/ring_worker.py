"""Daemon-side USRBIO ring worker: drain shm sqe rings, execute through the
storage/meta clients, push completions.

Reference analog: FuseClients::ioRingWorker coroutines (src/fuse/
FuseClients.h:189) + IoRing::process + PioV execute (src/fuse/IoRing.h:121,
PioV.h:35-37).  A dedicated thread blocks in t3fs_ior_pop_sqe (GIL released
inside ctypes) and feeds an asyncio queue; a drainer coroutine COALESCES
whatever reads are queued into one `read_file_ranges` batch per wave (the
PioV gather — one RPC per storage node per wave, not one per sqe), while
writes run concurrently as before.

The port of t3fs/fuse/ring_worker.py, a copy with its imports re-pointed:
the rings and iovs are the port's (t3fs_torch/lib/usrbio.py), whose shm
layout is the reference's, so it serves an app ring of either package.
"""

from __future__ import annotations

import asyncio
import threading

from t3fs_torch.client.meta_client import MetaClient
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.lib.usrbio import Completion, CSqe, IoRing, IoVec, OP_READ
from t3fs_torch.usrbio.ring_client import RingArena, RingClient
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.status import StatusCode, StatusError

MAX_INFLIGHT = 256


class RingWorker:
    """Serves one app ring: resolves idents (inode ids) to layouts via meta,
    moves bytes between the shared iov and storage."""

    def __init__(self, ring_name: str, meta: MetaClient,
                 storage: StorageClient):
        self.ring = IoRing(ring_name, create=False)
        # IoVec open maps the app segment's real (fstat'd) size
        self.iov = IoVec(self.ring.iov_name, create=False)
        self.meta = meta
        self.storage = storage
        # ring-native lean path (data_plane=ring): the APP's iov is the
        # registered arena — storage nodes write read payloads straight
        # into it (shm alias or one-sided), SQEs pack from the CSqes with
        # no per-IO ReadIO/IOResult objects, end-to-end zero-copy
        self._ring_plane: RingClient | None = None
        if getattr(storage.cfg, "data_plane", "rpc") == "ring":
            try:
                self._ring_plane = RingClient(
                    storage,
                    arena=RingArena.wrap_iov(storage.buf_registry,
                                             self.iov))
            except Exception:
                self._ring_plane = None    # rpc drain path below
        self._layouts: dict[int, object] = {}        # ident -> FileLayout
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._sem: asyncio.Semaphore | None = None
        self._queue: asyncio.Queue | None = None
        self._drainer: asyncio.Task | None = None
        self._tasks: set[asyncio.Task] = set()

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        # one permit per in-flight SQE (not per wave): the cap the old
        # per-sqe dispatch enforced, kept under coalescing
        self._sem = asyncio.Semaphore(MAX_INFLIGHT)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._tasks: set[asyncio.Task] = set()
        self._drainer = asyncio.create_task(self._drain_loop())
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name=f"t3fs-ring-{self.ring.name}")
        self._thread.start()

    def _pump(self) -> None:
        """Blocking sqe drain on a plain thread; hops to the loop queue
        in BURSTS: one batched native pop (one blocking wait, then the
        whole submitted wave drains without further syscalls) and a
        single call_soon_threadsafe per wave — not one of each per sqe.
        The drainer then coalesces whole waves into one storage batch."""
        while not self._stop.is_set():
            burst = self.ring.pop_sqes(max_n=MAX_INFLIGHT, timeout_ms=100)
            if not burst:
                continue
            self._loop.call_soon_threadsafe(self._put_burst, burst)

    def _put_burst(self, burst: list) -> None:
        for s in burst:
            self._queue.put_nowait(s)

    def _complete(self, sqe: CSqe, result: int, status: int) -> None:
        self.ring.complete(sqe.userdata, result, status)
        self._sem.release()                  # one permit per sqe

    def _complete_group(self, cqes: list[tuple[int, int, int]]) -> None:
        # one native call + one cq mutex pass for the whole group
        self.ring.complete_many(cqes)
        for _ in cqes:
            self._sem.release()

    def _spawn(self, coro) -> None:
        # the loop only weak-refs tasks: keep a hard reference until done
        t = asyncio.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _drain_loop(self) -> None:
        """Gather queued sqes into waves: all reads of a wave coalesce
        into read_file_ranges batches (the PioV gather); writes dispatch
        concurrently.  Gathering stops when the per-sqe inflight budget
        is spent — backpressure instead of unbounded fan-out."""
        while True:
            wave: list[CSqe] = []
            try:
                sqe = await self._queue.get()
                wave.append(sqe)
                await self._sem.acquire()
                while len(wave) < MAX_INFLIGHT and not self._sem.locked():
                    try:
                        nxt = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    wave.append(nxt)
                    await self._sem.acquire()
            except asyncio.CancelledError:
                # stop() cancelled us mid-gather: sqes already popped into
                # `wave` are no longer in the queue, so stop()'s queue
                # drain can't see them — error-complete here or the user
                # blocked on those cqes hangs at unmount
                for s in wave:
                    self.ring.complete(s.userdata, -1,
                                       int(StatusCode.CANCELLED))
                raise
            reads = [s for s in wave if s.op == OP_READ]
            writes = [s for s in wave if s.op != OP_READ]
            # fire the wave without awaiting it: the next wave may start
            # gathering immediately (completion order is the ring's own
            # business — userdata matching, like the reference)
            if reads:
                by_ident: dict[int, list[CSqe]] = {}
                for s in reads:
                    by_ident.setdefault(s.ident, []).append(s)
                for group in by_ident.values():
                    self._spawn(self._dispatch_reads(group))
            for s in writes:
                self._spawn(self._dispatch_write(s))

    async def _dispatch_reads(self, group: list[CSqe]) -> None:
        """One ident's reads of a wave -> ONE read_file_ranges batch.
        Error isolation is per group; each sqe completes exactly once."""
        done = 0
        try:
            lay = await self._layout(group[0].ident)
            if self._ring_plane is not None:
                # lean path: bytes land in the app iov server-side; holes
                # and errors zero-fill in place (the read_file_ranges
                # contract) and every sqe completes full-length, status 0
                lens = await self._ring_plane.read_ranges_into(
                    lay, [(s.ident, s.file_off, s.len, s.iov_off)
                          for s in group])
                self._complete_group([(s.userdata, n, 0)
                                      for s, n in zip(group, lens)])
                done = len(group)
                return
            outs = await self.storage.read_file_ranges(
                lay, [(s.ident, s.file_off, s.len) for s in group])
            for s, (data, _results) in zip(group, outs):
                self.iov.write_at(s.iov_off, data)
            self._complete_group([(s.userdata, len(data), 0)
                                  for s, (data, _r) in zip(group, outs)])
            done = len(group)
        except StatusError as e:
            for s in group[done:]:
                self._complete(s, -1, e.code)
        except asyncio.CancelledError:
            # stop() is tearing us down mid-RPC: the user still needs a
            # cqe for every sqe or unmount hangs on the missing ones
            for s in group[done:]:
                self._complete(s, -1, int(StatusCode.CANCELLED))
            raise
        except Exception:
            for s in group[done:]:
                self._complete(s, -1, int(StatusCode.INTERNAL))

    async def _dispatch_write(self, sqe: CSqe) -> None:
        try:
            n = await self._execute_write(sqe)
            self._complete(sqe, n, 0)
        except StatusError as e:
            self._complete(sqe, -1, e.code)
        except asyncio.CancelledError:
            self._complete(sqe, -1, int(StatusCode.CANCELLED))
            raise
        except Exception:
            self._complete(sqe, -1, int(StatusCode.INTERNAL))

    async def _layout(self, ident: int):
        lay = self._layouts.get(ident)
        if lay is None:
            ino = await self.meta.stat_inode(ident)
            lay = self._layouts[ident] = ino.layout
        return lay

    async def _execute_write(self, sqe: CSqe) -> int:
        lay = await self._layout(sqe.ident)
        payload = self.iov.read_at(sqe.iov_off, sqe.len)
        results = await self.storage.write_file_range(
            lay, sqe.ident, sqe.file_off, payload)
        for r in results:
            if r.status.code != int(StatusCode.OK):
                raise StatusError(r.status.code, r.status.message)
        await self.meta.report_write_position(sqe.ident,
                                              sqe.file_off + sqe.len)
        return len(payload)

    async def stop(self) -> None:
        self._stop.set()
        if self._thread:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join)
        if self._drainer is not None:
            self._drainer.cancel()
            # run its CancelledError handler (which error-completes
            # any half-gathered wave) BEFORE the ring closes below
            await reap_task(self._drainer, what="usrbio ring drainer")
        # sqes already popped from the shm ring but still queued would
        # otherwise vanish without a cqe — error-complete them
        if self._queue is not None:
            while True:
                try:
                    sqe = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                self.ring.complete(sqe.userdata, -1,
                                   int(StatusCode.CANCELLED))
        # dispatched-but-unfinished sqes: cancel their tasks and WAIT for
        # the CancelledError handlers to push their cqes before the ring
        # goes away (cancel alone schedules, it doesn't run them)
        pending = [t for t in list(self._tasks) if not t.done()]
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        if self._ring_plane is not None:
            # detach sessions + deregister the iov BEFORE it unmaps below
            await self._ring_plane.close()
            self._ring_plane = None
        self.ring.close()
        self.iov.close(unlink=False)
