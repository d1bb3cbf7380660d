"""CheckpointWriter: pytree -> RS(k+m) stripes, fanned out with admission.

Write path per stripe: one fused device encode+CRC launch produces the
parity AND the checksum every chunk commits with (no host crc32c on the
hot path); the k+m shard writes fan out under two windows — a fleet-wide
stripe window (`window` stripes in flight) and per-chain admission
(`per_chain` chunk writes per chain), so one slow chain backpressures only
its own shards while the rest of the fleet keeps streaming.

Resume: data inodes are hash-derived (manifest.ckpt_inode), so a re-run of
an interrupted save probes the stored chunk CRCs (no-payload reads) against
the freshly encoded ones and rewrites ONLY the shards that are missing or
stale.  Partial failures retry the same way: write_encoded reports
per-shard IOResults, and only the failed shards go back out.

The manifest commit (CheckpointStore.commit: write-temp + meta rename) runs
strictly after every shard is durable — the checkpoint is visible iff all
its bytes are.

The port of t3fs/ckpt/writer.py.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from t3fs_torch.ckpt.manifest import (CheckpointManifest, CkptLeaf, ckpt_inode,
                                flatten_tree)
from t3fs_torch.ckpt.store import CheckpointStore
from t3fs_torch.client.ec_client import ChainAdmission, ECLayout, ECStorageClient
from t3fs_torch.storage.types import ReadIO
from t3fs_torch.utils import tracing
from t3fs_torch.utils.status import StatusCode, make_error

log = logging.getLogger("t3fs_torch.ckpt")


@dataclass
class SaveStats:
    stripes_total: int = 0
    stripes_skipped: int = 0      # every shard already committed (resume)
    shards_written: int = 0
    shards_skipped: int = 0
    shards_retried: int = 0
    bytes_written: int = 0
    manifest_path: str = ""


@dataclass
class _LeafPlan:
    path: str
    arr: np.ndarray
    data: bytes
    entry: CkptLeaf = None
    crcs: list[int] = field(default_factory=list)   # filled per stripe


class CheckpointWriter:
    """Saves pytrees into one checkpoint directory."""

    def __init__(self, ec: ECStorageClient, fs, layout: ECLayout,
                 directory: str, window: int = 8, per_chain: int = 2,
                 shard_retries: int = 2):
        self.ec = ec
        self.fs = fs
        self.layout = layout
        self.store = CheckpointStore(fs, directory)
        self.window = window
        self.per_chain = per_chain
        self.shard_retries = shard_retries

    async def save(self, step: int, tree, resume: bool = True,
                   on_stripe: Callable[[int, int], None] | None = None
                   ) -> SaveStats:
        """Save `tree` as checkpoint `step`.  `resume=True` (default) makes
        an interrupted save restartable: already-committed shards are
        detected by CRC probe and skipped.  `on_stripe(done, total)` fires
        after each stripe settles (progress/interruption hook)."""
        lay = self.layout
        k, m, cs = lay.k, lay.m, lay.chunk_size
        stripe_bytes = k * cs
        leaves, treedef = flatten_tree(tree)
        plans: list[_LeafPlan] = []
        for path, leaf in leaves:
            arr = np.asarray(leaf)
            data = arr.tobytes()
            num_stripes = -(-len(data) // stripe_bytes) if data else 0
            plan = _LeafPlan(path=path, arr=arr, data=data)
            plan.entry = CkptLeaf(
                path=path, dtype=str(arr.dtype), shape=list(arr.shape),
                nbytes=len(data),
                inode=ckpt_inode(self.store.directory, step, path),
                num_stripes=num_stripes,
                shard_crcs=[0] * (num_stripes * (k + m)))
            plans.append(plan)

        stats = SaveStats()
        work = [(plan, s) for plan in plans
                for s in range(plan.entry.num_stripes)]
        stats.stripes_total = len(work)
        window = asyncio.Semaphore(self.window)
        admission = ChainAdmission(self.per_chain)
        done = 0
        lock = asyncio.Lock()

        async def one(plan: _LeafPlan, stripe: int) -> None:
            nonlocal done
            async with window:
                with tracing.span("ckpt.write_stripe", path=plan.path,
                                  stripe=stripe):
                    await self._write_stripe(plan, stripe, resume, admission,
                                             stats)
            if on_stripe is not None:
                async with lock:
                    done += 1
                    on_stripe(done, stats.stripes_total)

        with tracing.start_root("ckpt.save", step=step,
                                stripes=stats.stripes_total):
            # deterministic order so an interrupt leaves a contiguous-ish
            # prefix; the window keeps `window` stripes in flight regardless
            await asyncio.gather(*(one(plan, s) for plan, s in work))

            manifest = CheckpointManifest(
                version=1, directory=self.store.directory, step=step,
                treedef=treedef, layout=lay,
                leaves=[plan.entry for plan in plans],
                created_at=time.time())
            stats.manifest_path = await self.store.commit(manifest)
        return stats

    async def _write_stripe(self, plan: _LeafPlan, stripe: int, resume: bool,
                            admission: ChainAdmission,
                            stats: SaveStats) -> None:
        lay = self.layout
        k, m, cs = lay.k, lay.m, lay.chunk_size
        inode = plan.entry.inode
        chunk = plan.data[stripe * k * cs:(stripe + 1) * k * cs]
        enc = await self.ec.encode_stripe(lay, chunk)
        plan.entry.shard_crcs[stripe * (k + m):(stripe + 1) * (k + m)] = \
            enc.crcs

        to_write = tuple(range(k + m))
        if resume:
            to_write = await self._probe_stale(inode, stripe, enc)
            skipped = (k + m) - len(to_write)
            stats.shards_skipped += skipped
            if not to_write:
                stats.stripes_skipped += 1
                return

        for attempt in range(self.shard_retries + 1):
            results = await self.ec.write_encoded(
                lay, inode, stripe, enc, shards=to_write,
                admission=admission)
            failed = tuple(s for s, r in zip(to_write, results)
                           if r.status.code != int(StatusCode.OK))
            ok = len(to_write) - len(failed)
            stats.shards_written += ok
            stats.bytes_written += sum(
                len(enc.contents[s]) for s, r in zip(to_write, results)
                if r.status.code == int(StatusCode.OK))
            if not failed:
                return
            if attempt == self.shard_retries:
                codes = {s: StatusCode(r.status.code).name
                         for s, r in zip(to_write, results)
                         if r.status.code != int(StatusCode.OK)}
                raise make_error(
                    StatusCode.TARGET_OFFLINE,
                    f"ckpt save {plan.path!r} stripe {stripe}: shards "
                    f"{codes} failed after {self.shard_retries + 1} "
                    f"attempts")
            log.warning("ckpt save %r stripe %d: retrying shards %s",
                        plan.path, stripe, failed)
            stats.shards_retried += len(failed)
            to_write = failed

    async def _probe_stale(self, inode: int, stripe: int, enc
                           ) -> tuple[int, ...]:
        """No-payload CRC probe: which shards still need writing?  A shard
        is committed iff the stored chunk CRC equals the freshly encoded
        one (holes: iff the chunk is absent).  Probe failures (offline
        chain, transient error) count the shard as stale — rewriting a
        written shard is idempotent, skipping an unwritten one is not."""
        lay = self.layout
        k, m = lay.k, lay.m
        ios = []
        for s in range(k + m):
            cid = (lay.data_chunk(inode, stripe, s) if s < k
                   else lay.parity_chunk(inode, stripe, s - k))
            ios.append(ReadIO(chunk_id=cid,
                              chain_id=lay.shard_chain(stripe, s),
                              no_payload=True))
        results, _ = await self.ec._fast.batch_read(ios)
        stale = []
        for s, r in enumerate(results):
            hole = s < k and enc.lens[s] == 0
            if hole:
                if r.status.code != int(StatusCode.CHUNK_NOT_FOUND):
                    stale.append(s)   # REMOVE again (or probe failed)
            elif (r.status.code != int(StatusCode.OK)
                  or int(r.checksum) != enc.crcs[s]
                  or r.length != len(enc.contents[s])):
                stale.append(s)
        return tuple(stale)
