"""ChecksumBackend on PyTorch/CUDA: twin of t3fs/storage/codec_backend.py.

The storage write path awaits `payload_crc(payload)` on every CRAQ update
and resync write.  The backend is chosen by config:

  cpu    -- host CRC32C; large buffers hop to a thread so the event loop
            never blocks.
  cuda   -- micro-batched device offload ("gpu", "device" and "tpu", the
            value existing deployments carry, name it too): concurrent
            updates enqueue payloads, a worker drains the queue, buckets them
            by padded segment count, and runs ONE CRC words kernel
            (cuda_codec.crc_words_raw) per bucket.  Raw CRC is
            zero-preserving, so buffers are front-padded and the true-length
            affine constant is applied per buffer on the host.
  null   -- returns 0 and disables verification.

Unlike the JAX backend, batch rows are not padded to powers of four: that
padding bounded the set of shapes JAX compiles, and the CUDA kernel has no
per-shape compile.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from collections import defaultdict
from concurrent.futures import CancelledError, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.ops.codec import crc32c as cpu_crc32c, crc32c_combine
from t3fs_torch.ops.crc32c import default_matrices
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.status import StatusCode, make_error

log = logging.getLogger("t3fs_torch.storage.codec")

# below this, the host CRC is cheaper than a device round trip
DEFAULT_MIN_DEVICE_BYTES = 64 << 10
SEG_BYTES = 512
SEG_WORDS = SEG_BYTES // 4
# payloads hop off the event loop above this even on the cpu backend
CPU_OFFLOAD_BYTES = 256 << 10


class ChecksumBackend:
    """Interface: async batched CRC32C for the storage node hot path."""

    name = "base"

    async def payload_crc(self, data: bytes) -> int:
        raise NotImplementedError

    def combine(self, a: int, b: int, len_b: int) -> int:
        """CRC32C of a concatenation from the parts' CRCs (append rollup)."""
        return crc32c_combine(a, b, len_b)

    @property
    def verify_enabled(self) -> bool:
        return True

    async def close(self) -> None:
        pass


class CpuChecksumBackend(ChecksumBackend):
    name = "cpu"

    async def payload_crc(self, data: bytes) -> int:
        if len(data) >= CPU_OFFLOAD_BYTES:
            return await asyncio.to_thread(cpu_crc32c, data)
        return cpu_crc32c(data)


class NullChecksumBackend(ChecksumBackend):
    name = "null"

    async def payload_crc(self, data: bytes) -> int:
        return 0

    def combine(self, a: int, b: int, len_b: int) -> int:
        return 0   # every checksum path must agree on 0

    @property
    def verify_enabled(self) -> bool:
        return False


@dataclass
class _Pending:
    data: bytes
    future: asyncio.Future
    loop: asyncio.AbstractEventLoop


class CudaChecksumBackend(ChecksumBackend):
    """Micro-batching CRC32C offload to the GPU.

    Double-buffered: batch n+1 is packed into its pinned staging buffer,
    copied and launched on the codec stream before batch n's results are
    pulled, so the device computes n while the host packs n+1.  There are
    two staging buffers, so batch n+1 never overwrites the buffer batch n's
    copy may still be reading; before a buffer is packed again, the event
    recorded after its last copy is waited on."""

    name = "cuda"

    def __init__(self, max_batch: int = 64, max_wait_us: int = 300,
                 min_device_bytes: int = DEFAULT_MIN_DEVICE_BYTES,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_us / 1e6
        self.min_device_bytes = min_device_bytes
        self._q: asyncio.Queue[_Pending] = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        # the codec thread: every table build, pack, copy and launch runs here
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="t3fs-torch-codec")
        self._fns: dict[int, Callable] = {}
        self._stream: torch.cuda.Stream | None = None
        self._staging: list[torch.Tensor | None] = [None, None]
        self._staging_done: list[torch.cuda.Event | None] = [None, None]
        self._turn = 0
        self._closed = False
        self.batches = 0
        self.batched_items = 0

    # --- public API ---

    async def payload_crc(self, data: bytes) -> int:
        if self._closed:
            # fail fast: enqueueing after close() would restart the worker
            # against a dead pool
            raise make_closed_error()
        if len(data) < self.min_device_bytes:
            return cpu_crc32c(data)
        loop = asyncio.get_running_loop()
        if self._worker is None or self._worker.done():
            self._worker = loop.create_task(self._worker_loop())
        fut = loop.create_future()
        await self._q.put(_Pending(data, fut, loop))
        return await fut

    async def close(self) -> None:
        self._closed = True
        if self._worker is not None:
            self._worker.cancel()
            await reap_task(self._worker, log, "cuda codec worker")
            self._worker = None
        # fail anything still queued so in-flight payload_crc() awaits don't
        # hang a node shutdown under write load
        err = make_closed_error()
        while not self._q.empty():
            item = self._q.get_nowait()
            if not item.future.done():
                item.future.set_exception(err)
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._staging = [None, None]

    def warmup(self, payload_sizes: list[int]) -> None:
        """Load (building if needed) the kernel library, build the tables of
        the given payload sizes' buckets and allocate the staging buffers
        for a full batch of the largest -- call off the hot path."""
        if self._closed:
            return
        try:
            self._pool.submit(self._warm, list(payload_sizes)).result()
        except CancelledError:
            return

    # --- batching worker ---

    async def _worker_loop(self) -> None:
        loop = asyncio.get_running_loop()
        batch: list[_Pending] = []
        in_flight: tuple | None = None       # dispatched, results not pulled
        try:
            while True:
                try:
                    if in_flight is None:
                        first = await self._q.get()
                    else:
                        # traffic pause: bound how long the in-flight
                        # batch's callers wait for their CRCs
                        first = await asyncio.wait_for(self._q.get(),
                                                       self.max_wait_s)
                except asyncio.TimeoutError:
                    await loop.run_in_executor(self._pool, self._resolve,
                                               in_flight)
                    in_flight = None
                    continue
                batch = [first]
                deadline = loop.time() + self.max_wait_s
                while len(batch) < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(
                            await asyncio.wait_for(self._q.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                groups: dict[int, list[_Pending]] = defaultdict(list)
                for item in batch:
                    groups[self._bucket_words(len(item.data))].append(item)
                self.batches += len(groups)
                self.batched_items += len(batch)
                try:
                    dispatched = await loop.run_in_executor(
                        self._pool, self._dispatch, groups)
                except Exception as e:
                    log.exception("device CRC dispatch failed; failing batch")
                    for item in batch:
                        item.loop.call_soon_threadsafe(
                            _set_exception_safe, item.future, e)
                    dispatched = None
                batch = []
                # pull the PREVIOUS batch only now -- its kernel ran on the
                # device while this batch was packed and launched
                if in_flight is not None:
                    await loop.run_in_executor(self._pool, self._resolve,
                                               in_flight)
                in_flight = dispatched
        except asyncio.CancelledError:
            err = make_closed_error()
            for item in batch:
                if not item.future.done():
                    item.future.set_exception(err)
            if in_flight is not None:
                for items, _res, _ev in in_flight:
                    for item in items:
                        if not item.future.done():
                            item.future.set_exception(err)
            raise

    @staticmethod
    def _bucket_words(nbytes: int) -> int:
        """Pad to a power-of-two number of 512-byte segments (the engine's
        size-class ladder; one table set per bucket)."""
        segs = max(1, -(-nbytes // SEG_BYTES))
        p = 1
        while p < segs:
            p <<= 1
        return p * SEG_WORDS

    def _fn(self, chunk_words: int) -> Callable:
        fn = self._fns.get(chunk_words)
        if fn is None:
            from t3fs_torch.ops.cuda_codec import make_crc32c_words_raw

            fn = self._fns[chunk_words] = make_crc32c_words_raw(
                chunk_words, device=self.device)
        return fn

    def _warm(self, payload_sizes: list[int]) -> None:
        if self.device.type == "cuda":
            from t3fs_torch.ops._build import library

            library("crc_words")
        words = [self._bucket_words(s) for s in payload_sizes]
        for w in words:
            self._fn(w)
        if words:
            for i in range(2):
                self._staging_buffer(i, self.max_batch * max(words) * 4)

    def _stream_ctx(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)

    def _staging_buffer(self, i: int, nbytes: int) -> torch.Tensor:
        """Staging buffer i, at least nbytes, once its last copy is done."""
        done = self._staging_done[i]
        if done is not None:
            done.synchronize()
        buf = self._staging[i]
        if buf is None or buf.numel() < nbytes:
            size = 1 << max(0, nbytes - 1).bit_length()
            buf = torch.empty(size, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._staging[i] = buf
        return buf

    def _dispatch(self, groups: dict[int, list[_Pending]]) -> list:
        """Codec thread, non-blocking on the device: pack every bucket into
        this batch's staging buffer, copy and launch one kernel per bucket,
        and return (items, host result, event) per bucket."""
        cuda = self.device.type == "cuda"
        total = sum(cw * 4 * len(items) for cw, items in groups.items())
        turn = self._turn
        self._turn ^= 1
        buf = self._staging_buffer(turn, total)
        out: list = []
        with self._stream_ctx():
            try:
                self._pack_and_launch(groups, buf, out)
            finally:
                if cuda:
                    # after every copy out of this buffer, even if a later
                    # bucket failed to launch
                    done = torch.cuda.Event()
                    done.record()
                    self._staging_done[turn] = done
        return out

    def _pack_and_launch(self, groups: dict[int, list[_Pending]],
                         buf: torch.Tensor, out: list) -> None:
        cuda = self.device.type == "cuda"
        host = buf.numpy()
        off = 0
        for chunk_words, items in groups.items():
            nbytes = chunk_words * 4
            size = nbytes * len(items)
            rows = host[off:off + size].reshape(len(items), nbytes)
            for i, item in enumerate(items):
                # FRONT-pad: raw CRC is zero-preserving
                pad = nbytes - len(item.data)
                rows[i, :pad] = 0
                rows[i, pad:] = np.frombuffer(item.data, dtype=np.uint8)
            words = buf[off:off + size].view(torch.int32).view(
                len(items), chunk_words)
            off += size
            raw = self._fn(chunk_words)(words.to(self.device, non_blocking=True))
            event = None
            if cuda:
                res = torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)
                res.copy_(raw, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                res = raw
            out.append((items, res, event))

    def _resolve(self, dispatched: list) -> None:
        """Codec thread: wait for each bucket's results and deliver CRCs.
        Failures are per bucket -- one bucket's device error must not strand
        the other buckets' callers."""
        mats = default_matrices()
        for items, res, event in dispatched:
            try:
                if event is not None:
                    event.synchronize()
                raw = res.numpy().view(np.uint32)
            except Exception as e:
                log.exception("device CRC resolve failed; failing bucket")
                for item in items:
                    item.loop.call_soon_threadsafe(
                        _set_exception_safe, item.future, e)
                continue
            for i, item in enumerate(items):
                crc = int(raw[i]) ^ mats.affine_const(len(item.data))
                item.loop.call_soon_threadsafe(
                    _set_result_safe, item.future, crc)


def make_closed_error() -> Exception:
    return make_error(StatusCode.INTERNAL, "checksum backend closed")


def _set_result_safe(fut: asyncio.Future, value: int) -> None:
    if not fut.done():
        fut.set_result(value)


def _set_exception_safe(fut: asyncio.Future, exc: Exception) -> None:
    if not fut.done():
        fut.set_exception(exc)


def make_checksum_backend(name, **kw) -> ChecksumBackend:
    """Factory for the config seam: checksum_backend = cpu | cuda | null.

    "cuda", "gpu", "device" and "tpu" (the value existing deployments
    carry) all map to the batching CUDA backend; pass device="cpu" to run it
    on the plain versions.  An already-constructed backend passes through,
    and a callable is a factory called once per node."""
    if isinstance(name, ChecksumBackend):
        return name
    if callable(name):
        return make_checksum_backend(name())
    if name in ("cpu", "", None):
        return CpuChecksumBackend()
    if name in ("cuda", "gpu", "device", "tpu"):
        return CudaChecksumBackend(**kw)
    if name == "null":
        return NullChecksumBackend()
    raise ValueError(f"unknown checksum backend {name!r}")
