"""Soak workload drivers: one class per traffic shape.

Every driver owns its OWN StorageClient (per-workload channels, hedging,
and data plane — rpc or the ring — so drivers contend on the
fabric, not on a shared client), verifies EVERY byte it reads against
content it can recompute (the zero-wrong-bytes assertion is per-read,
not a final sweep), and records per-op completion times + latencies for
the harvest layer.

Rate control lives in the shared base:

- **open loop**: arrivals are paced at `demand_ops_s` from the driver's
  seeded RNG, independent of completions — a stalled fabric makes
  latency (and eventually shed arrivals) visible instead of silently
  slowing the offered load.  In-flight ops are capped; arrivals beyond
  the cap are counted as `shed`, not queued (bounded memory under a
  fault).
- **closed loop**: `concurrency` workers issue back-to-back — the
  classic saturating client (checkpoint cycles, graysort).

Stop discipline: `request_stop()` stops new arrivals; `drain()` waits
`drain_timeout_s` for in-flight ops then cancels and counts stragglers.
Errors are counted and the op retried later — a soak driver must
survive a crash fault, that is the point of the exercise.

The port of t3fs/soak/drivers.py, with two differences: every EC client a
driver builds comes from `SoakContext.make_ec`, whose codec is
TorchECCodec on the card (B2 + B1 on a checkpoint's stripes) unless the
context's checksum_backend is "cpu" (the codec's plain versions); and the
graysort op checks its writes' Status, where the reference's call raises
on every op.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from hashlib import blake2b

import numpy as np

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
from t3fs_torch.soak.spec import SoakSpec, WorkloadSpec
from t3fs_torch.utils.status import StatusCode

# disjoint inode namespace for soak-generated raw-chunk files (below the
# meta allocator's range, above the benches'): | (driver_idx << 24)
SOAK_NS = 0x50AC << 40

REC_LEN = 100                    # gensort record layout (sort driver)


def block_bytes(seed: int, inode: int, index: int, n: int) -> bytes:
    """Deterministic content for block `index` of file `inode`: cheap to
    recompute at verify time, distinct across files and blocks."""
    h = blake2b(f"{seed}:{inode}:{index}".encode(), digest_size=32,
                person=b"t3fs-sok").digest()
    return (h * (n // 32 + 1))[:n]


@dataclass
class OpRecord:
    t: float            # completion, seconds since driver start
    lat_s: float
    ok: bool
    nbytes: int = 0


class Driver:
    """Shared lifecycle + rate control; subclasses implement the ops."""

    def __init__(self, spec: SoakSpec, wl: WorkloadSpec, idx: int,
                 ctx: "SoakContext"):
        self.spec = spec
        self.wl = wl
        self.idx = idx
        self.ctx = ctx
        self.name = wl.name
        self.rng = np.random.default_rng(spec.seed * 1000 + idx)
        self.ops: list[OpRecord] = []
        self.errors = 0
        self.wrong_bytes = 0
        self.shed = 0
        self.cancelled = 0
        self._stop = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        self._inflight: set[asyncio.Task] = set()
        self._t0 = 0.0
        self.sc: StorageClient | None = None

    # -- subclass surface ---------------------------------------------------

    async def setup(self) -> None:                 # pragma: no cover
        pass

    async def one_op(self, worker: int) -> int:
        """Run one operation, return payload bytes moved.  Raise on
        failure (counted as an error by the loop); verification
        mismatches increment `wrong_bytes` AND raise."""
        raise NotImplementedError

    async def teardown(self) -> None:
        if self.sc is not None:
            await self.sc.close()

    # -- helpers ------------------------------------------------------------

    def make_client(self, **cfg_kw) -> StorageClient:
        cfg_kw.setdefault("data_plane", self.wl.data_plane)
        cfg_kw.setdefault("read_hedging", self.wl.read_hedging)
        return self.ctx.make_client(**cfg_kw)

    def _bad_bytes(self, what: str, n: int = 1) -> None:
        self.wrong_bytes += n
        raise AssertionError(f"{self.name}: wrong bytes in {what}")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._t0 = time.monotonic()
        if self.wl.mode == "closed":
            self._tasks = [
                asyncio.create_task(self._closed_worker(i),
                                    name=f"soak-{self.name}-{i}")
                for i in range(self.wl.concurrency)]
        else:
            self._tasks = [asyncio.create_task(
                self._open_pacer(), name=f"soak-{self.name}-pacer")]

    def request_stop(self) -> None:
        self._stop.set()

    async def drain(self, timeout_s: float) -> None:
        """Pacer/workers exit at the stop flag; in-flight ops get
        `timeout_s` to finish before cancellation (counted)."""
        self._stop.set()
        pend = [t for t in (*self._tasks, *self._inflight) if not t.done()]
        if pend:
            done, not_done = await asyncio.wait(pend, timeout=timeout_s)
            for t in not_done:
                t.cancel()
                self.cancelled += 1
            if not_done:
                await asyncio.gather(*not_done, return_exceptions=True)
        self._tasks = []
        self._inflight.clear()

    async def _timed(self, worker: int) -> None:
        t0 = time.monotonic()
        try:
            nbytes = await self.one_op(worker)
        except asyncio.CancelledError:
            raise
        except Exception:
            self.errors += 1
            self.ops.append(OpRecord(time.monotonic() - self._t0,
                                     time.monotonic() - t0, False))
            return
        self.ops.append(OpRecord(time.monotonic() - self._t0,
                                 time.monotonic() - t0, True, nbytes))

    async def _closed_worker(self, worker: int) -> None:
        while not self._stop.is_set():
            await self._timed(worker)
            # an op that fails before its first await would otherwise
            # spin this loop without ever yielding to the event loop
            await asyncio.sleep(0)

    async def _open_pacer(self) -> None:
        period = 1.0 / self.wl.demand_ops_s
        cap = max(4, self.wl.concurrency * 4)
        next_at = time.monotonic()
        worker = 0
        while not self._stop.is_set():
            # exponential inter-arrivals (seeded): a Poisson open loop
            next_at += self.rng.exponential(period)
            delay = next_at - time.monotonic()
            if delay > 0:
                try:
                    await asyncio.wait_for(self._stop.wait(), delay)
                    break
                except asyncio.TimeoutError:
                    pass
            self._inflight = {t for t in self._inflight if not t.done()}
            if len(self._inflight) >= cap:
                self.shed += 1        # arrival shed, never queued
                continue
            t = asyncio.create_task(self._timed(worker),
                                    name=f"soak-{self.name}-op")
            self._inflight.add(t)
            worker = (worker + 1) % max(1, self.wl.concurrency)


@dataclass
class SoakContext:
    """What drivers need from the runner: the live fabric + factories."""
    cluster: object                       # LocalCluster
    spec: SoakSpec
    repl_chains: list[int] = field(default_factory=list)
    ec_chain_ids: list[int] = field(default_factory=list)
    # "cuda": EC codecs on the card; "cpu": on their plain versions
    checksum_backend: str = "cuda"

    def make_client(self, **cfg_kw) -> StorageClient:
        cfg_kw.setdefault("retry_backoff_s", 0.05)
        cfg_kw.setdefault("max_retries", 12)
        cl = self.cluster
        return StorageClient(cl.mgmtd_client.routing,
                             config=StorageClientConfig(**cfg_kw),
                             refresh_routing=cl.mgmtd_client.refresh)

    def make_ec(self, sc: StorageClient):
        from t3fs_torch.client.ec_client import ECStorageClient
        from t3fs_torch.client.ec_codec import TorchECCodec
        device = "cpu" if self.checksum_backend == "cpu" else "cuda"
        return ECStorageClient(sc, codec=TorchECCodec(device=device))

    def filesystem(self, sc: StorageClient):
        from t3fs_torch.fuse.vfs import FileSystem
        return FileSystem(self.cluster.mc, sc)


# --------------------------------------------------------------- dataloader

class DataloaderDriver(Driver):
    """Zipf-distributed random block reads over a pre-written file —
    the training-input shape.  rpc and ring instances differ only in
    `data_plane` (the A/A pair the fairness grade compares)."""

    async def setup(self) -> None:
        self.sc = self.make_client()
        self.lay = FileLayout(chunk_size=self.spec.chunk_size,
                              chains=self.ctx.repl_chains)
        self.inode = SOAK_NS | (self.idx << 24)
        bs = self.wl.read_size
        self.nblocks = max(1, (self.wl.file_mb << 20) // bs)
        for lo in range(0, self.nblocks, 16):
            hi = min(self.nblocks, lo + 16)
            data = b"".join(block_bytes(self.spec.seed, self.inode, i, bs)
                            for i in range(lo, hi))
            rs = await self.sc.write_file_range(self.lay, self.inode,
                                                lo * bs, data)
            assert all(r.status.code == int(StatusCode.OK) for r in rs)

    async def one_op(self, worker: int) -> int:
        bs = self.wl.read_size
        i = int(self.rng.zipf(self.wl.zipf_a) - 1) % self.nblocks
        data, _ = await self.sc.read_file_range(self.lay, self.inode,
                                                i * bs, bs)
        if data != block_bytes(self.spec.seed, self.inode, i, bs):
            self._bad_bytes(f"block {i}")
        return bs


# --------------------------------------------------------------- checkpoint

class CheckpointDriver(Driver):
    """save → restore → verify → GC cycles over the EC chains.  The step
    counter advances only on success: a save interrupted by a crash
    fault RESUMES the same step next op (CRC-probe resume), never
    restarts from scratch."""

    async def setup(self) -> None:
        from t3fs_torch.ckpt.reader import CheckpointReader
        from t3fs_torch.ckpt.store import CheckpointStore
        from t3fs_torch.ckpt.writer import CheckpointWriter
        from t3fs_torch.client.ec_client import ECLayout
        self.sc = self.make_client()
        self.fs = self.ctx.filesystem(self.sc)
        lay = ECLayout.create(self.spec.ec_k, self.spec.ec_m,
                              self.spec.ec_chunk_size,
                              chains=self.ctx.ec_chain_ids)
        self.ec = self.ctx.make_ec(self.sc)
        self.directory = f"/soak/ckpt-{self.name}"
        self.writer = CheckpointWriter(self.ec, self.fs, lay,
                                       self.directory)
        self.reader = CheckpointReader(self.ec, self.fs, self.directory)
        self.store = CheckpointStore(self.fs, self.directory)
        n = (self.wl.tree_kb << 10) // 8 // 2
        r = np.random.default_rng(self.spec.seed + self.idx)
        self.tree = {"w": r.standard_normal(n),
                     "b": r.standard_normal(n)}
        self.step = 1
        self.resumed_stripes = 0

    async def one_op(self, worker: int) -> int:
        stats = await self.writer.save(self.step, self.tree)
        self.resumed_stripes += stats.stripes_skipped
        got = await self.reader.restore(step=self.step)
        for k, v in self.tree.items():
            if not np.array_equal(got[k], v):
                self._bad_bytes(f"step {self.step} leaf {k}")
        if self.step > self.wl.keep_last:
            await self.store.gc(self.sc, keep_last=self.wl.keep_last)
        self.step += 1              # only after a verified cycle
        return 2 * sum(v.nbytes for v in self.tree.values())

    async def teardown(self) -> None:
        await self.ec.close()
        await super().teardown()


# ------------------------------------------------------------------ kvcache

class KVCacheDriver(Driver):
    """put/get churn against a KVCacheTier; `byte_budget_kb` > 0 turns
    on capacity-eviction pressure.  Values embed (key, version) so a get
    verifies content without racing its own concurrent puts: a miss
    (evicted / not yet visible) is legal, a value whose embedded key or
    fill pattern is wrong never is."""

    async def setup(self) -> None:
        from t3fs_torch.kvcache import KVCacheTier, KVCacheTierConfig
        self.sc = self.make_client()
        cfg = KVCacheTierConfig(
            block_size=max(4096, self.wl.value_bytes + 256),
            byte_budget=self.wl.byte_budget_kb << 10,
            gc_interval_s=0.5, hit_sample=4,
            ledger_flush_interval_s=0.1)
        self.tier = KVCacheTier(self.sc, self.ctx.repl_chains,
                                namespace=f"soak-{self.name}",
                                config=cfg, writer_id=self.idx + 1)
        await self.tier.start(run_gc=self.wl.byte_budget_kb > 0)
        self.version: dict[int, int] = {}
        self._next_key = 0

    def _value(self, key_i: int, ver: int) -> bytes:
        head = f"{key_i}:{ver}:".encode()
        pad = block_bytes(self.spec.seed, key_i, 0,
                          self.wl.value_bytes - len(head))
        return head + pad

    def _key(self, key_i: int) -> bytes:
        return f"soak-{self.name}-k{key_i}".encode()

    async def one_op(self, worker: int) -> int:
        if self.rng.random() < self.wl.put_ratio:
            key_i = self._next_key % self.wl.keys
            self._next_key += 1
            ver = self.version.get(key_i, 0) + 1
            await self.tier.put(self._key(key_i), self._value(key_i, ver))
            self.version[key_i] = ver
            return self.wl.value_bytes
        idxs = [int(i) for i in
                self.rng.integers(0, self.wl.keys, self.wl.get_batch)]
        vals = await self.tier.get_many([self._key(i) for i in idxs])
        n = 0
        for key_i, v in zip(idxs, vals):
            if v is None:
                continue            # evicted or never put: a legal miss
            n += len(v)
            want_prefix = f"{key_i}:".encode()
            head, _, _pad = v.partition(b":")
            ok = v.startswith(want_prefix)
            if ok:
                try:
                    ver = int(v.split(b":", 2)[1])
                    ok = v == self._value(key_i, ver)
                except (ValueError, IndexError):
                    ok = False
            if not ok:
                self._bad_bytes(f"key {key_i}")
        return n

    async def teardown(self) -> None:
        await self.tier.stop()
        await super().teardown()


# ----------------------------------------------------------------- metascan

class MetaScanDriver(Driver):
    """FUSE-layer directory listings + stat sweeps over a seeded tree —
    the metadata-heavy tenant that must not starve behind bulk I/O."""

    async def setup(self) -> None:
        self.sc = self.make_client()
        self.fs = self.ctx.filesystem(self.sc)
        self.root = f"/soak/scan-{self.name}"
        self.sizes: dict[str, int] = {}
        for d in range(self.wl.dirs):
            await self.fs.mkdirs(f"{self.root}/d{d}", recursive=True)
            for i in range(self.wl.files_per_dir):
                path = f"{self.root}/d{d}/f{i}"
                content = block_bytes(self.spec.seed, d, i, 64 + i)
                await self.fs.write_file(path, content)
                self.sizes[path] = len(content)

    async def one_op(self, worker: int) -> int:
        d = int(self.rng.integers(0, self.wl.dirs))
        entries = await self.fs.readdir(f"{self.root}/d{d}")
        if len(entries) != self.wl.files_per_dir:
            self._bad_bytes(f"dir d{d} entry count {len(entries)}")
        for i in self.rng.choice(self.wl.files_per_dir,
                                 size=min(4, self.wl.files_per_dir),
                                 replace=False):
            path = f"{self.root}/d{d}/f{int(i)}"
            ino = await self.fs.stat(path)
            length = await self.fs.file_length(ino)
            if length != self.sizes[path]:
                self._bad_bytes(f"stat {path} length {length}")
        return 0


# ----------------------------------------------------------------- graysort

class GraySortDriver(Driver):
    """A miniaturized two-phase GraySort per op (the sort_bench job
    shape): scan input → range-partition runs → sort each partition →
    write output → validate sortedness + XOR key checksum.  Every byte
    crosses the fabric four times, which is why it rides the soak."""

    async def setup(self) -> None:
        self.sc = self.make_client()
        self.lay = FileLayout(chunk_size=self.spec.chunk_size,
                              chains=self.ctx.repl_chains)
        base = SOAK_NS | (self.idx << 24)
        self.in_inode = base | 1 << 20
        self.run_inode = base | 2 << 20       # + partition
        self.out_inode = base | 3 << 20       # + partition
        self.nrec = (self.wl.sort_mb << 20) // REC_LEN
        rows = np.random.default_rng(self.spec.seed + self.idx).integers(
            0, 256, (self.nrec, REC_LEN), dtype=np.uint8)
        self.in_sum = int(np.bitwise_xor.reduce(
            rows[:, 0:8].copy().view(">u8").ravel()))
        rs = await self.sc.write_file_range(self.lay, self.in_inode, 0,
                                            rows.tobytes())
        assert all(r.status.code == int(StatusCode.OK) for r in rs)

    async def one_op(self, worker: int) -> int:
        parts = self.wl.sort_partitions
        data, _ = await self.sc.read_file_range(self.lay, self.in_inode,
                                                0, self.nrec * REC_LEN)
        rows = np.frombuffer(data, dtype=np.uint8).reshape(-1, REC_LEN)
        hi = rows[:, 0:8].copy().view(">u8").ravel()
        p = (hi // ((1 << 64) // parts)).clip(0, parts - 1).astype(np.int64)
        order = np.argsort(p, kind="stable")
        sp, bounds = p[order], None
        bounds = np.searchsorted(sp, np.arange(parts + 1))
        run_lens = []
        for part in range(parts):
            seg = rows[order[bounds[part]:bounds[part + 1]]]
            run_lens.append(len(seg))
            rs = await self.sc.write_file_range(
                self.lay, self.run_inode + part, 0, seg.tobytes())
            for r in rs:
                # a swallowed write failure would resurface as a phantom
                # checksum mismatch — fail the op (counted, retried) here
                # (a WireStatus has no raise_if_error of its own)
                r.status.to_status().raise_if_error()
        out_sum, prev_hi = 0, -1
        for part in range(parts):
            n = run_lens[part]
            if n == 0:
                continue
            blob, _ = await self.sc.read_file_range(
                self.lay, self.run_inode + part, 0, n * REC_LEN)
            seg = np.frombuffer(blob, dtype=np.uint8).reshape(-1, REC_LEN)
            keys = [seg[:, c] for c in range(9, -1, -1)]
            seg = seg[np.lexsort(keys)]
            ws = await self.sc.write_file_range(
                self.lay, self.out_inode + part, 0, seg.tobytes())
            for r in ws:
                r.status.to_status().raise_if_error()
            shi = seg[:, 0:8].copy().view(">u8").ravel()
            if len(shi) and (int(shi[0]) < prev_hi
                             or np.any(shi[:-1] > shi[1:])):
                self._bad_bytes(f"partition {part} not sorted")
            if len(shi):
                prev_hi = int(shi[-1])
            out_sum ^= int(np.bitwise_xor.reduce(shi)) if len(shi) else 0
        if out_sum != self.in_sum:
            self._bad_bytes("output checksum")
        for part in range(parts):    # runs+output are per-op scratch
            await self.sc.remove_file_chunks(self.lay,
                                             self.run_inode + part)
            await self.sc.remove_file_chunks(self.lay,
                                             self.out_inode + part)
        return 4 * self.nrec * REC_LEN


DRIVER_KINDS = {
    "dataloader": DataloaderDriver,
    "checkpoint": CheckpointDriver,
    "kvcache": KVCacheDriver,
    "metascan": MetaScanDriver,
    "graysort": GraySortDriver,
}


def build_driver(spec: SoakSpec, wl: WorkloadSpec, idx: int,
                 ctx: SoakContext) -> Driver:
    return DRIVER_KINDS[wl.kind](spec, wl, idx, ctx)
