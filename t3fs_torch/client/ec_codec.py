"""EC stripe codec on PyTorch/CUDA: twin of t3fs/client/ec_codec.py (write side).

ECStorageClient awaits `encode_verified(data_shards, k, m)` on every stripe
write.  TorchECCodec micro-batches concurrent requests that share a shape
key into one device call, exactly as the reference ECCodec does:

  ("enc", k, m, L)   RAID-6 and L % 4 == 0: the RAID-6 word kernel
                     (cuda_codec.make_rs_encode_words)       -> "cuda-words"
  ("encv", k, m, L)  RAID-6 and L % 512 == 0: the fused stripe step, B2
                     then B1 (cuda_codec.make_stripe_encode_step_words)
                                                        -> "cuda-encode-words"
  otherwise          the plain PyTorch bit-matmul path (torch_codec), as the
                     JAX package runs XLA there           -> "torch-bitmatmul"

The read-side keys (degraded decode, repair, PM-MSR) are later slices of the
port; their methods raise NotImplementedError naming the ROADMAP.md item.
"""

from __future__ import annotations

import asyncio
import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.utils.aio import reap_task

log = logging.getLogger("t3fs_torch.client.ec_codec")

# the ROADMAP.md item that ports each key not carried yet
NOT_PORTED = {
    "rec": "ROADMAP.md Queue A item 5 (degraded decode, kernel B3)",
    "recv": "ROADMAP.md Queue A item 5 (degraded decode, kernel B3)",
    "rep": "ROADMAP.md Queue A item 6 (reduced-read repair, kernel B4)",
    "mencv": "ROADMAP.md Queue A item 7 (PM-MSR codec)",
    "mrep": "ROADMAP.md Queue A item 7 (PM-MSR codec)",
    "mdecv": "ROADMAP.md Queue A item 7 (PM-MSR codec)",
}


def _not_ported(key: str) -> NotImplementedError:
    return NotImplementedError(
        f"TorchECCodec: '{key}' is not ported yet; see {NOT_PORTED[key]}")


@dataclass
class _Pending:
    rows: np.ndarray             # one request's shards (k, L)
    future: asyncio.Future
    loop: asyncio.AbstractEventLoop


def _set_result_safe(fut: asyncio.Future, value) -> None:
    if not fut.done():
        fut.set_result(value)


def _set_exception_safe(fut: asyncio.Future, err) -> None:
    if not fut.done():
        fut.set_exception(err)


class TorchECCodec:
    """Batched device codec for EC stripes with a per-shape function cache.

    kind keys: ("enc", k, m, L) and ("encv", k, m, L); requests under one key
    stack into a single call."""

    def __init__(self, max_batch: int = 32, max_wait_us: int = 300,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_us / 1e6
        self._q: asyncio.Queue[tuple[tuple, _Pending]] = asyncio.Queue()
        self._worker: asyncio.Task | None = None
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="t3fs-torch-ec")
        self._fns: dict[tuple, Callable] = {}
        self._closed = False
        # observability: which implementation served each call
        # ("cuda-words" | "cuda-encode-words" | "torch-bitmatmul")
        self.codec_counts: dict[str, int] = {}
        self.last_codec: str | None = None
        self.batches = 0
        self.batched_items = 0

    # --- public API (called from the event loop) ---

    async def encode(self, data_shards: np.ndarray, k: int, m: int
                     ) -> np.ndarray:
        """(k, L) uint8 data shards -> (m, L) uint8 parity."""
        L = data_shards.shape[-1]
        return await self._submit(("enc", k, m, L), data_shards)

    async def encode_verified(self, data_shards: np.ndarray, k: int, m: int
                              ) -> tuple[np.ndarray, np.ndarray]:
        """(k, L) uint8 data shards -> (parity (m, L) uint8,
        crcs (k+m,) uint32): parity + CRC32C of every shard (data first,
        then parity) from the same device call."""
        L = data_shards.shape[-1]
        return await self._submit(("encv", k, m, L), data_shards)

    async def reconstruct(self, present_rows, present, want, k, m):
        raise _not_ported("rec")

    async def reconstruct_verified(self, present_rows, present, want, k, m):
        raise _not_ported("recv")

    async def repair(self, helper_rows, coeffs, k=8, m=2):
        raise _not_ported("rep")

    async def msr_encode_verified(self, data_shards, k, m):
        raise _not_ported("mencv")

    async def msr_repair(self, helper_rows, failed_slot, k=8, m=2):
        raise _not_ported("mrep")

    async def msr_decode_verified(self, present_rows, present, want, k, m):
        raise _not_ported("mdecv")

    def warmup_decode(self, patterns, L, k=8, m=2, batch_sizes=(1,)):
        raise _not_ported("recv")

    def warmup_repair(self, coeff_rows, L, k=8, m=2, batch_sizes=(1,)):
        raise _not_ported("rep")

    def warmup_msr(self, slots, L, k=8, m=2, batch_sizes=(1,)):
        raise _not_ported("mrep")

    async def close(self) -> None:
        self._closed = True
        if self._worker is not None:
            self._worker.cancel()
            await reap_task(self._worker, log, "TorchECCodec submit worker")
            self._worker = None
        err = RuntimeError("TorchECCodec closed")
        while not self._q.empty():
            _key, item = self._q.get_nowait()
            _set_exception_safe(item.future, err)
        self._pool.shutdown(wait=True, cancel_futures=True)

    # --- batching worker ---

    async def _submit(self, key: tuple, rows: np.ndarray):
        if self._closed:
            raise RuntimeError("TorchECCodec closed")
        loop = asyncio.get_running_loop()
        if self._worker is None or self._worker.done():
            self._worker = loop.create_task(self._worker_loop())
        fut = loop.create_future()
        await self._q.put((key, _Pending(rows, fut, loop)))
        return await fut

    async def _worker_loop(self) -> None:
        loop = asyncio.get_running_loop()
        batch: list[tuple[tuple, _Pending]] = []
        try:
            while True:
                batch = [await self._q.get()]
                # drain-then-sleep-then-drain, never wait_for(q.get()): on
                # py<3.12 a timed-out wait_for can cancel Queue.get after it
                # dequeued an item, silently dropping it
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._q.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                if len(batch) < self.max_batch and self.max_wait_s > 0:
                    await asyncio.sleep(self.max_wait_s)
                    while len(batch) < self.max_batch:
                        try:
                            batch.append(self._q.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                groups: dict[tuple, list[_Pending]] = {}
                for key, item in batch:
                    groups.setdefault(key, []).append(item)
                self.batches += len(groups)
                self.batched_items += len(batch)
                try:
                    await loop.run_in_executor(self._pool, self._flush,
                                               groups)
                except Exception as e:
                    log.exception("EC codec flush failed; failing batch")
                    for _key, item in batch:
                        item.loop.call_soon_threadsafe(
                            _set_exception_safe, item.future, e)
                batch = []
        except asyncio.CancelledError:
            err = RuntimeError("TorchECCodec closed")
            for _key, item in batch:
                _set_exception_safe(item.future, err)
            raise

    def _flush(self, groups: dict[tuple, list[_Pending]]) -> None:
        """Device work, on the codec thread: one call per shape-key group
        covering every stacked request."""
        for key, items in groups.items():
            fn = self._fn(key)
            stacked = np.stack([it.rows for it in items])
            out = fn(stacked)
            for i, it in enumerate(items):
                # fused steps return a tuple of stacked arrays (shards,
                # crcs); each caller gets its row of every output
                res = (tuple(o[i] for o in out) if isinstance(out, tuple)
                       else out[i])
                it.loop.call_soon_threadsafe(
                    _set_result_safe, it.future, res)

    # --- kernel selection + function cache ---

    def _fn(self, key: tuple) -> Callable:
        fn = self._fns.get(key)
        if fn is None:
            if key[0] == "enc":
                fn = self._build_encode(key)
            elif key[0] == "encv":
                fn = self._build_encode_verified(key)
            else:
                raise _not_ported(key[0])
            self._fns[key] = fn
        return fn

    def _count(self, codec: str) -> None:
        self.codec_counts[codec] = self.codec_counts.get(codec, 0) + 1
        self.last_codec = codec

    def _words(self, stacked: np.ndarray) -> torch.Tensor:
        """(n, k, L) uint8 -> (n, k, L/4) int32 words on the device."""
        return torch.from_numpy(stacked.view(np.int32)).to(self.device)

    def _build_encode(self, key: tuple) -> Callable:
        _kind, k, m, L = key
        rs = default_rs(k, m)
        if rs.raid6 and L % 4 == 0:
            from t3fs_torch.ops.cuda_codec import make_rs_encode_words

            enc = make_rs_encode_words(rs, device=self.device)

            def encode_words(stacked: np.ndarray) -> np.ndarray:
                self._count("cuda-words")
                out = enc(self._words(stacked)).cpu().numpy()
                return out.view(np.uint8).reshape(stacked.shape[0], m, L)
            return encode_words

        from t3fs_torch.ops.torch_codec import make_rs_encode

        enc = make_rs_encode(rs, device=self.device)

        def encode_torch(stacked: np.ndarray) -> np.ndarray:
            self._count("torch-bitmatmul")
            return enc(torch.from_numpy(stacked).to(self.device)).cpu().numpy()
        return encode_torch

    def _build_encode_verified(self, key: tuple) -> Callable:
        """Fused encode + CRC: one call returns (parity, crcs), crcs over the
        data shards then the parity shards."""
        _kind, k, m, L = key
        rs = default_rs(k, m)
        if rs.raid6 and L % 512 == 0:
            from t3fs_torch.ops.cuda_codec import make_stripe_encode_step_words

            step = make_stripe_encode_step_words(L // 4, k, m,
                                                 device=self.device)

            def encode_words(stacked: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
                self._count("cuda-encode-words")
                parity, crcs = step(self._words(stacked))
                parity = parity.cpu().numpy().view(np.uint8).reshape(
                    stacked.shape[0], m, L)
                return parity, crcs.cpu().numpy().view(np.uint32)
            return encode_words

        from t3fs_torch.ops.torch_codec import make_crc32c_batch, make_rs_encode

        encf = make_rs_encode(rs, device=self.device)
        crcf = make_crc32c_batch(L, device=self.device)

        def encode_torch(stacked: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            self._count("torch-bitmatmul")
            data = torch.from_numpy(stacked).to(self.device)
            n = stacked.shape[0]
            parity = encf(data)
            dcrc = crcf(data.reshape(n * k, L)).reshape(n, k)
            pcrc = crcf(parity.reshape(n * m, L)).reshape(n, m)
            crcs = torch.cat([dcrc, pcrc], dim=1)
            return parity.cpu().numpy(), crcs.cpu().numpy().view(np.uint32)
        return encode_torch
