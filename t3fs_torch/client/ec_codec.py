"""EC stripe codec on PyTorch/CUDA: twin of t3fs/client/ec_codec.py.

ECStorageClient awaits `encode_verified` on every stripe write,
`reconstruct_verified` on every degraded read or full-k rebuild, and
`repair` per sub-shard of a reduced-read repair (and for the LRC local XOR
parities of a write).  TorchECCodec micro-batches concurrent requests that
share a key into one device call, exactly as the reference ECCodec does:

  ("enc", k, m, L)   RAID-6 and L % 4 == 0: B2 (make_rs_encode_words)
                                                              -> "cuda-words"
  ("encv", k, m, L)  RAID-6 and L % 512 == 0: the fused stripe step, B2
                     then B1 (make_stripe_encode_step_words)
                                                        -> "cuda-encode-words"
  ("rec", present, want, k, m, L)
                     RAID-6 and L % 4 == 0: B3 (make_rs_reconstruct_words)
                                                          -> "cuda-rec-words"
                     otherwise B5 (make_rs_reconstruct_bytes)
                                                          -> "cuda-bitmatmul"
  ("recv", present, want, k, m, L)
                     RAID-6 and L % 512 == 0: the fused decode step, B3 then
                     B1 (make_stripe_decode_step_words) -> "cuda-decode-words"
  ("rep", coeffs, k, m, L)
                     L % 512 == 0: the fused repair step, B4 then B1
                     (make_repair_step_words)           -> "cuda-repair-words"
                     otherwise B4 on the words padded to a whole word, CRC by
                     torch_codec.make_crc32c_batch  -> "cuda-repair-words-odd"
  otherwise          the plain PyTorch bit-matmul path (torch_codec), as the
                     JAX package runs XLA there           -> "torch-bitmatmul"

The PM-MSR keys are a later slice of the port; their methods raise
NotImplementedError naming the ROADMAP.md item.
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
from t3fs_torch.ops.repair_program import schedule_repair_program
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.utils.aio import reap_task

log = logging.getLogger("t3fs_torch.client.ec_codec")

# the ROADMAP.md item that ports each key not carried yet
NOT_PORTED = {
    "mencv": "ROADMAP.md Queue A item 7 (PM-MSR codec)",
    "mrep": "ROADMAP.md Queue A item 7 (PM-MSR codec)",
    "mdecv": "ROADMAP.md Queue A item 7 (PM-MSR codec)",
    "warmup_msr": "ROADMAP.md Queue A item 7 (PM-MSR codec)",
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

    kind keys: ("enc", k, m, L), ("encv", k, m, L), ("rec", present, want,
    k, m, L), ("recv", present, want, k, m, L) and ("rep", coeffs, k, m, L);
    requests under one key stack into a single call."""

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
        # observability: which implementation served each call ("cuda-words"
        # | "cuda-encode-words" | "cuda-rec-words" | "cuda-bitmatmul" |
        # "cuda-decode-words" | "cuda-repair-words" | "cuda-repair-words-odd"
        # | "torch-bitmatmul"); warmups count too
        self.codec_counts: dict[str, int] = {}
        self.last_codec: str | None = None
        self.flushes = 0                 # worker flushes (one per drained batch)
        self.batches = 0                 # key groups over all flushes
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

    async def reconstruct(self, present_rows: np.ndarray,
                          present: tuple[int, ...], want: tuple[int, ...],
                          k: int, m: int) -> np.ndarray:
        """(k, L) uint8 present shards -> (len(want), L) uint8."""
        L = present_rows.shape[-1]
        return await self._submit(("rec", tuple(present), tuple(want), k, m, L),
                                  present_rows)

    async def reconstruct_verified(self, present_rows: np.ndarray,
                                   present: tuple[int, ...],
                                   want: tuple[int, ...], k: int, m: int
                                   ) -> tuple[np.ndarray, np.ndarray]:
        """(k, L) uint8 present shards -> (rebuilt (len(want), L) uint8,
        crcs (k + len(want),) uint32): decode + CRC32C of the survivors (in
        `present` order) and of the rebuilt shards (in `want` order) from
        the same device call."""
        L = present_rows.shape[-1]
        return await self._submit(("recv", tuple(present), tuple(want), k, m, L),
                                  present_rows)

    async def repair(self, helper_rows: np.ndarray, coeffs: tuple[int, ...],
                     k: int = 8, m: int = 2) -> tuple[np.ndarray, np.uint32]:
        """(h, L) uint8 helper rows -> (rebuilt (L,) uint8, crc uint32): one
        scheduled GF(2^8) repair program (coeffs[i] is helper i's
        coefficient) and the CRC32C of the rebuilt bytes.  Requests with the
        same (coeffs, L) stack into one call."""
        L = helper_rows.shape[-1]
        key = ("rep", tuple(int(c) for c in coeffs), k, m, L)
        return await self._submit(key, helper_rows)

    async def msr_encode_verified(self, data_shards, k, m):
        raise _not_ported("mencv")

    async def msr_repair(self, helper_rows, failed_slot, k=8, m=2):
        raise _not_ported("mrep")

    async def msr_decode_verified(self, present_rows, present, want, k, m):
        raise _not_ported("mdecv")

    def warmup_decode(self, patterns: list[tuple[tuple[int, ...],
                                                 tuple[int, ...]]],
                      L: int, k: int = 8, m: int = 2,
                      batch_sizes: tuple[int, ...] = (1,)) -> None:
        """Build the hot (present, want, L) decode steps off the read path:
        the kernel libraries, the tables, and one call on zeros per batch
        size.  Each is its own job on the codec thread, so close() drops
        whatever has not started; a failure is logged, not raised."""
        self._warmup([(("recv", tuple(p), tuple(w), k, m, L), (nb, k, L))
                      for p, w in patterns for nb in batch_sizes])

    def warmup_repair(self, coeff_rows: list[tuple[int, ...]], L: int,
                      k: int = 8, m: int = 2,
                      batch_sizes: tuple[int, ...] = (1,)) -> None:
        """The repair twin of warmup_decode: one job per (coeffs, batch
        size) of the programs a repair drill will run."""
        self._warmup([(("rep", tuple(int(c) for c in cs), k, m, L),
                       (nb, len(cs), L))
                      for cs in coeff_rows for nb in batch_sizes])

    def warmup_msr(self, slots, L, k=8, m=2, batch_sizes=(1,)):
        raise _not_ported("warmup_msr")

    def _warmup(self, jobs: list[tuple[tuple, tuple[int, ...]]]) -> None:
        from concurrent.futures import CancelledError

        def one(key: tuple, shape: tuple[int, ...]) -> None:
            if self._closed:
                return
            try:
                self._fn(key)(np.zeros(shape, dtype=np.uint8))
            except Exception:
                # loud, since that key pays its build on its first call,
                # but the rest of the warmup goes on
                log.exception("EC codec warmup failed (key=%s, shape=%s)",
                              key, shape)

        futs = []
        for key, shape in jobs:
            if self._closed:
                return
            try:
                futs.append(self._pool.submit(one, key, shape))
            except RuntimeError:          # pool already shut down
                return
        for f in futs:
            try:
                f.result()
            except CancelledError:
                return

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
                self.flushes += 1
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
            build = {"enc": self._build_encode,
                     "encv": self._build_encode_verified,
                     "rec": self._build_reconstruct,
                     "recv": self._build_reconstruct_verified,
                     "rep": self._build_repair}.get(key[0])
            if build is None:
                raise _not_ported(key[0])
            fn = build(key)
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

    def _build_reconstruct(self, key: tuple) -> Callable:
        _kind, present, want, k, m, L = key
        rs = default_rs(k, m)
        n_want = len(want)
        if rs.raid6 and L % 4 == 0:
            from t3fs_torch.ops.cuda_codec import make_rs_reconstruct_words

            rec = make_rs_reconstruct_words(present, want, rs, device=self.device)

            def reconstruct_words(stacked: np.ndarray) -> np.ndarray:
                self._count("cuda-rec-words")
                out = rec(self._words(stacked)).cpu().numpy()
                return out.view(np.uint8).reshape(stacked.shape[0], n_want, L)
            return reconstruct_words

        # codes that are not RAID-6, and odd lengths: the byte-plane kernel
        from t3fs_torch.ops.cuda_codec import make_rs_reconstruct_bytes

        rec = make_rs_reconstruct_bytes(present, want, rs, device=self.device)

        def reconstruct_bytes(stacked: np.ndarray) -> np.ndarray:
            self._count("cuda-bitmatmul")
            return rec(torch.from_numpy(stacked).to(self.device)).cpu().numpy()
        return reconstruct_bytes

    def _build_reconstruct_verified(self, key: tuple) -> Callable:
        """Fused decode + CRC: one call returns (rebuilt, crcs), crcs over
        the survivors then the rebuilt shards."""
        _kind, present, want, k, m, L = key
        rs = default_rs(k, m)
        n_want = len(want)
        if rs.raid6 and L % 512 == 0:
            from t3fs_torch.ops.cuda_codec import make_stripe_decode_step_words

            step = make_stripe_decode_step_words(L // 4, present, want, k, m,
                                                 device=self.device)

            def decode_words(stacked: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
                self._count("cuda-decode-words")
                rebuilt, crcs = step(self._words(stacked))
                rebuilt = rebuilt.cpu().numpy().view(np.uint8).reshape(
                    stacked.shape[0], n_want, L)
                return rebuilt, crcs.cpu().numpy().view(np.uint32)
            return decode_words

        from t3fs_torch.ops.torch_codec import make_crc32c_batch, make_rs_reconstruct

        recf = make_rs_reconstruct(present, want, rs, device=self.device)
        crcf = make_crc32c_batch(L, device=self.device)

        def decode_torch(stacked: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            self._count("torch-bitmatmul")
            shards = torch.from_numpy(stacked).to(self.device)
            n = stacked.shape[0]
            rebuilt = recf(shards)
            scrc = crcf(shards.reshape(n * k, L)).reshape(n, k)
            rcrc = crcf(rebuilt.reshape(n * n_want, L)).reshape(n, n_want)
            crcs = torch.cat([scrc, rcrc], dim=1)
            return rebuilt.cpu().numpy(), crcs.cpu().numpy().view(np.uint32)
        return decode_torch

    def _build_repair(self, key: tuple) -> Callable:
        """Scheduled single-row repair + CRC of the rebuilt bytes: the fused
        repair step on 512-multiple lengths; otherwise B4 on the rows padded
        to a whole word, cut back to L, and the plain PyTorch CRC."""
        _kind, coeffs, k, m, L = key
        prog = schedule_repair_program(coeffs)
        h = prog.num_helpers
        if L % 512 == 0:
            from t3fs_torch.ops.cuda_codec import make_repair_step_words

            step = make_repair_step_words(L // 4, prog, device=self.device)

            def repair_words(stacked: np.ndarray
                             ) -> tuple[np.ndarray, np.ndarray]:
                self._count("cuda-repair-words")
                rebuilt, crcs = step(self._words(stacked))
                rebuilt = rebuilt.cpu().numpy().view(np.uint8).reshape(
                    stacked.shape[0], L)
                return rebuilt, crcs.cpu().numpy().view(np.uint32)
            return repair_words

        from t3fs_torch.ops.cuda_codec import make_repair_subshard_words
        from t3fs_torch.ops.torch_codec import make_crc32c_batch

        rep = make_repair_subshard_words(prog, default_rs(k, m),
                                         device=self.device)
        crcf = make_crc32c_batch(L, device=self.device)
        pad = (-L) % 4

        def repair_odd(stacked: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            self._count("cuda-repair-words-odd")
            n = stacked.shape[0]
            rows = np.pad(stacked, ((0, 0), (0, 0), (0, pad))) if pad else stacked
            out = rep(self._words(np.ascontiguousarray(rows).reshape(n, h, -1)))
            out = out.view(torch.uint8).reshape(n, L + pad)[:, :L].contiguous()
            return out.cpu().numpy(), crcf(out).cpu().numpy().view(np.uint32)
        return repair_odd
