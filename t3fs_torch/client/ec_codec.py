"""EC stripe codec on PyTorch/CUDA: twin of t3fs/client/ec_codec.py.

ECStorageClient awaits `encode_verified` on every stripe write,
`reconstruct_verified` on every degraded read or full-k rebuild, and
`repair` per sub-shard of a reduced-read repair (and for the LRC local XOR
parities of a write); on a pm-msr layout it awaits `msr_encode_verified`,
`msr_repair` and `msr_decode_verified` instead.  TorchECCodec micro-batches
concurrent requests that share a key into one device call, exactly as the
reference ECCodec does.  Every route runs the cuda_codec wrappers, which
launch the kernels on a CUDA codec and run their plain versions on a CPU
codec:

  ("enc", k, m, L)   RAID-6 and L % 4 == 0: B2 (make_rs_encode_words)
                                                              -> "cuda-words"
                     otherwise B5 (make_rs_encode_bytes)  -> "cuda-bitmatmul"
  ("encv", k, m, L)  RAID-6 and L % 512 == 0: the fused stripe step, B2
                     then B1 (make_stripe_encode_step_words)
                                                        -> "cuda-encode-words"
                     otherwise B2 (RAID-6, L % 4 == 0) or B5, then B6
                     (make_stripe_encode_step_bytes)    -> "cuda-encode-bytes"
  ("rec", present, want, k, m, L)
                     RAID-6 and L % 4 == 0: B3 (make_rs_reconstruct_words)
                                                          -> "cuda-rec-words"
                     otherwise B5 (make_rs_reconstruct_bytes)
                                                          -> "cuda-bitmatmul"
  ("recv", present, want, k, m, L)
                     RAID-6 and L % 512 == 0: the fused decode step, B3 then
                     B1 (make_stripe_decode_step_words) -> "cuda-decode-words"
                     otherwise B5 then B6 (make_stripe_decode_step_bytes)
                                                        -> "cuda-decode-bytes"
  ("rep", coeffs, k, m, L)
                     L % 512 == 0: the fused repair step, B4 then B1
                     (make_repair_step_words)           -> "cuda-repair-words"
                     otherwise B4 on the rows padded to a whole word, then
                     B6 (make_repair_step_bytes)    -> "cuda-repair-words-odd"
  ("mencv", k, m, L) pm-msr encode: stage B on B2, CRCs on B1 or B6
                     (msr_codec.make_msr_encode_step)    -> "cuda-msr-encode"
  ("mrep", f, k, m, L)
                     pm-msr single-loss repair of slot f: stage B on B4
                     twice, CRC on B1 or B6 (make_msr_repair_step)
                                                         -> "cuda-msr-repair"
  ("mdecv", present, want, k, m, L)
                     pm-msr multi-loss decode: the dense GF(2) product, CRCs
                     on B1 or B6 (make_msr_decode_step)  -> "cuda-msr-decode"

Every code RSCode builds runs on every route: B3 past k = 32 runs B5 on the
words' byte view, B5 runs one launch per tile of <= 8 output shards and
<= 227 KiB of tables, B4 one per group of <= 32 helpers (cuda_codec); a
tiled call counts once under its route's name.
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
    k, m, L), ("recv", present, want, k, m, L), ("rep", coeffs, k, m, L),
    ("mencv", k, m, L), ("mrep", f, k, m, L) and ("mdecv", present, want,
    k, m, L); requests under one key stack into a single call."""

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
        # observability: which route served each call (the names in the
        # module doc); warmups count too
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

    async def msr_encode_verified(self, data_shards: np.ndarray, k: int,
                                  m: int) -> tuple[np.ndarray, np.ndarray]:
        """(k, L) uint8 raw data shards -> (parity (m, L) uint8,
        crcs (k+m,) uint32) under the pm-msr coupled generator; the data
        shards stay raw bytes (systematic)."""
        L = data_shards.shape[-1]
        return await self._submit(("mencv", k, m, L), data_shards)

    async def msr_repair(self, helper_rows: np.ndarray, failed_slot: int,
                         k: int = 8, m: int = 2
                         ) -> tuple[np.ndarray, np.uint32]:
        """(d, beta_len) uint8 helper projections -> (rebuilt chunk (L,)
        uint8, crc uint32).  helper_rows holds, for each of the d = k+m-1
        survivors in ascending slot order, its beta selected sub-chunks
        concatenated in ascending plane order; L = 2 * beta_len."""
        beta_len = helper_rows.shape[-1]
        key = ("mrep", int(failed_slot), k, m, 2 * beta_len)
        return await self._submit(key, helper_rows)

    async def msr_decode_verified(self, present_rows: np.ndarray,
                                  present: tuple[int, ...],
                                  want: tuple[int, ...], k: int, m: int
                                  ) -> tuple[np.ndarray, np.ndarray]:
        """(k, L) uint8 present pm-msr shards -> (rebuilt (len(want), L)
        uint8, crcs (k + len(want),) uint32): the multi-loss / degraded
        full-k path (exactly k survivor shards, never more than RS)."""
        L = present_rows.shape[-1]
        return await self._submit(("mdecv", tuple(present), tuple(want),
                                   k, m, L), present_rows)

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

    def warmup_msr(self, slots: list[int], L: int, k: int = 8, m: int = 2,
                   batch_sizes: tuple[int, ...] = (1,)) -> None:
        """The pm-msr twin of warmup_repair: the coupled encode and the
        projection repair of each failed slot in `slots`, one job per
        (key, batch size)."""
        keys = [(("mencv", k, m, L), (k, L))]
        keys += [(("mrep", int(f), k, m, L), (k + m - 1, L // 2)) for f in slots]
        self._warmup([(key, (nb, *shape)) for key, shape in keys
                      for nb in batch_sizes])

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
                     "rep": self._build_repair,
                     "mencv": self._build_msr_encode_verified,
                     "mrep": self._build_msr_repair,
                     "mdecv": self._build_msr_decode_verified}[key[0]]
            fn = build(key)
            self._fns[key] = fn
        return fn

    def _count(self, codec: str) -> None:
        self.codec_counts[codec] = self.codec_counts.get(codec, 0) + 1
        self.last_codec = codec

    def _words(self, stacked: np.ndarray) -> torch.Tensor:
        """(n, k, L) uint8 -> (n, k, L/4) int32 words on the device."""
        return torch.from_numpy(stacked.view(np.int32)).to(self.device)

    def _bytes(self, stacked: np.ndarray) -> torch.Tensor:
        """(n, ..., L) uint8 -> the same bytes on the device."""
        return torch.from_numpy(stacked).to(self.device)

    def _bytes_step(self, codec: str, step: Callable) -> Callable:
        """A byte-path step ((n, ...) uint8 -> (shards, crcs)) on numpy."""
        def run(stacked: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
            self._count(codec)
            shards, crcs = step(self._bytes(stacked))
            return shards.cpu().numpy(), crcs.cpu().numpy().view(np.uint32)
        return run

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

        # codes that are not RAID-6, and odd lengths: the byte-plane kernel
        from t3fs_torch.ops.cuda_codec import make_rs_encode_bytes

        enc = make_rs_encode_bytes(rs, device=self.device)

        def encode_bytes(stacked: np.ndarray) -> np.ndarray:
            self._count("cuda-bitmatmul")
            return enc(self._bytes(stacked)).cpu().numpy()
        return encode_bytes

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

        from t3fs_torch.ops.cuda_codec import make_stripe_encode_step_bytes

        return self._bytes_step("cuda-encode-bytes", make_stripe_encode_step_bytes(
            L, k, m, device=self.device))

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
            return rec(self._bytes(stacked)).cpu().numpy()
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

        from t3fs_torch.ops.cuda_codec import make_stripe_decode_step_bytes

        return self._bytes_step("cuda-decode-bytes", make_stripe_decode_step_bytes(
            L, present, want, k, m, device=self.device))

    def _build_repair(self, key: tuple) -> Callable:
        """Scheduled single-row repair + CRC of the rebuilt bytes: the fused
        repair step on 512-multiple lengths; otherwise B4 on the rows padded
        to a whole word, cut back to L, and B6."""
        _kind, coeffs, k, m, L = key
        prog = schedule_repair_program(coeffs)
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

        from t3fs_torch.ops.cuda_codec import make_repair_step_bytes

        return self._bytes_step("cuda-repair-words-odd", make_repair_step_bytes(
            L, prog, device=self.device))

    def _build_msr_encode_verified(self, key: tuple) -> Callable:
        _kind, k, m, L = key
        from t3fs_torch.ops.msr import default_msr
        from t3fs_torch.ops.msr_codec import make_msr_encode_step

        return self._bytes_step("cuda-msr-encode", make_msr_encode_step(
            default_msr(k, m), L, device=self.device))

    def _build_msr_repair(self, key: tuple) -> Callable:
        """The pm-msr projection rebuild: one call gives the whole rebuilt
        chunk and its CRC32C."""
        _kind, failed_slot, k, m, L = key
        from t3fs_torch.ops.msr import default_msr
        from t3fs_torch.ops.msr_codec import make_msr_repair_step

        return self._bytes_step("cuda-msr-repair", make_msr_repair_step(
            default_msr(k, m), failed_slot, L, device=self.device))

    def _build_msr_decode_verified(self, key: tuple) -> Callable:
        _kind, present, want, k, m, L = key
        from t3fs_torch.ops.msr import default_msr
        from t3fs_torch.ops.msr_codec import make_msr_decode_step

        return self._bytes_step("cuda-msr-decode", make_msr_decode_step(
            default_msr(k, m), present, want, L, device=self.device))
