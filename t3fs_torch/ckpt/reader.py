"""CheckpointReader: manifest-verified restore (healthy, partial, resharded,
degraded) + scrub.

Restore strategy is two-tier:

  * healthy stripes go through plain `StorageClient.read_file_ranges` over
    `ECLayout.data_file_layout()` — the layout whose chain_of() reproduces
    the EC data-chunk placement — in ONE batched fan-out for every selected
    leaf (the dataloader read path, reused verbatim; this is also what
    makes resharded N-writers -> M-readers restores disjoint range reads);
  * any stripe with a failed, missing, or CRC-stale piece falls back to
    `read_stripe_with_crcs`, whose first-k fan-out requests all k+m shards
    concurrently and completes on the first k to land — a straggling or
    dead shard becomes an erasure the fused decode+verify reconstruction
    covers, so degraded restore never waits out a slow node's timeout.

Every accepted chunk is checked against the manifest's committed CRCs:
directly-read shards via the stored CRC the storage layer returns with
every read, reconstructed shards via the fused step's device CRC — the
host hashes nothing except at-most-one trimmed tail shard per leaf.  A
shard whose stored CRC disagrees with the manifest is treated as LOST (not
merely re-read): reconstruction from parity recovers the committed bytes,
so restore survives stale or bit-rotted chunks, not just absent ones.

scrub() is the audit half: no-payload verify reads over every shard
(data + parity) compare server-side content, stored CRC, and manifest CRC;
bad shards are REMOVEd (so repair decodes instead of trusting a readable-
but-wrong chunk) and handed to `repair_stripe`.

The port of t3fs/ckpt/reader.py.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

import numpy as np

from t3fs_torch.ckpt.manifest import CheckpointManifest, CkptLeaf, unflatten_tree
from t3fs_torch.ckpt.store import CheckpointStore
from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
from t3fs_torch.ops.codec import crc32c
from t3fs_torch.storage.types import ReadIO, UpdateType
from t3fs_torch.utils import tracing
from t3fs_torch.utils.status import StatusCode, make_error

log = logging.getLogger("t3fs_torch.ckpt")


@dataclass
class ScrubReport:
    shards_checked: int = 0
    shards_missing: int = 0       # CHUNK_NOT_FOUND where content belongs
    shards_corrupt: int = 0       # server verify failed / CRC != manifest
    shards_repaired: int = 0
    stripes_unrecoverable: int = 0


def _select(manifest: CheckpointManifest,
            paths: list[str] | None) -> list[CkptLeaf]:
    if paths is None:
        return list(manifest.leaves)
    out = []
    for lf in manifest.leaves:
        for p in paths:
            p = p.rstrip("/")
            if lf.path == p or lf.path.startswith(p + "/"):
                out.append(lf)
                break
    return out


class CheckpointReader:
    """Restores and audits checkpoints from one directory."""

    def __init__(self, ec: ECStorageClient, fs, directory: str,
                 window: int = 8, read_hedging: str = "inherit"):
        self.ec = ec
        self.fs = fs
        self.store = CheckpointStore(fs, directory)
        self.window = window
        # "on"/"off" opts the healthy-path restore reads in/out of hedged
        # batch reads per call; "inherit" keeps the storage client's
        # setting (degraded stripes already tolerate stragglers via
        # first-k reads, so only the healthy fan-out needs this)
        self.read_hedging = read_hedging

    # --- restore ---

    async def restore(self, step: int | None = None,
                      paths: list[str] | None = None):
        """Rebuild the pytree of `step` (default latest).  `paths` filters
        to a subset of tree paths (partial restore): unselected leaves come
        back as None in the rebuilt structure."""
        manifest = await self.store.load(step)
        selected = _select(manifest, paths)
        arrays = await self._read_leaves(manifest, selected)
        index_of = {lf.path: i for i, lf in enumerate(manifest.leaves)}
        return unflatten_tree(
            manifest.treedef,
            {index_of[path]: arr for path, arr in arrays.items()})

    async def restore_shard(self, reader_index: int, num_readers: int,
                            step: int | None = None,
                            paths: list[str] | None = None
                            ) -> dict[str, np.ndarray]:
        """Resharded restore: reader i of M takes every M-th selected leaf
        (round-robin by manifest order), so M readers cover the checkpoint
        with DISJOINT read_file_ranges fan-outs — the N-writers-to-M-readers
        reshape needs no shuffle service, just the manifest."""
        if not (0 <= reader_index < num_readers):
            raise make_error(
                StatusCode.INVALID_ARG,
                f"reader {reader_index} outside 0..{num_readers - 1}")
        manifest = await self.store.load(step)
        selected = _select(manifest, paths)[reader_index::num_readers]
        return await self._read_leaves(manifest, selected)

    async def _read_leaves(self, manifest: CheckpointManifest,
                           selected: list[CkptLeaf]
                           ) -> dict[str, np.ndarray]:
        with tracing.start_root("ckpt.restore", step=manifest.step,
                                leaves=len(selected)):
            return await self._read_leaves_inner(manifest, selected)

    async def _read_leaves_inner(self, manifest: CheckpointManifest,
                                 selected: list[CkptLeaf]
                                 ) -> dict[str, np.ndarray]:
        lay = manifest.layout
        k, m, cs = lay.k, lay.m, lay.chunk_size
        flayout = lay.data_file_layout()
        bufs = {lf.path: bytearray(lf.nbytes) for lf in selected}
        # stripes whose data chains are all serving ride the batched
        # healthy path; the rest go straight to reconstruction (burning
        # the patient client's retry budget on a routed-out chain first
        # would stall the whole restore)
        degraded: list[tuple[CkptLeaf, int]] = []
        ranges: list[tuple[int, int, int]] = []
        range_leaf: list[CkptLeaf] = []
        for lf in selected:
            run_start = None
            for s in range(lf.num_stripes):
                healthy = not any(
                    self.ec._routed_out(lay.shard_chain(s, j))
                    for j in range(k)
                    if s * k * cs + j * cs < lf.nbytes)
                if healthy:
                    if run_start is None:
                        run_start = s
                    continue
                degraded.append((lf, s))
                if run_start is not None:
                    ranges.append((lf.inode, run_start * k * cs,
                                   min(s * k * cs, lf.nbytes)
                                   - run_start * k * cs))
                    range_leaf.append(lf)
                    run_start = None
            if run_start is not None:
                ranges.append((lf.inode, run_start * k * cs,
                               lf.nbytes - run_start * k * cs))
                range_leaf.append(lf)

        if ranges:
            out = await self.ec.sc.read_file_ranges(
                flayout, ranges,
                hedging=None if self.read_hedging == "inherit"
                else self.read_hedging)
            for (inode, offset, length), lf, (data, results) in zip(
                    ranges, range_leaf, out):
                pieces = flayout.chunk_span(offset, length)
                pos = 0
                bad_stripes: set[int] = set()
                for (idx, coff, span), r in zip(pieces, results):
                    stripe, j = divmod(idx, k)
                    want = lf.stripe_crcs(lay, stripe)[j]
                    stored_len = min(cs, lf.nbytes - idx * cs)
                    whole = coff == 0 and span == stored_len
                    if (r.status.code != int(StatusCode.OK)
                            or (whole and int(r.checksum) != want)):
                        bad_stripes.add(stripe)
                    elif stripe not in bad_stripes:
                        bufs[lf.path][offset + pos:offset + pos + span] = \
                            data[pos:pos + span]
                    pos += span
                degraded.extend((lf, s) for s in sorted(bad_stripes))

        window = asyncio.Semaphore(self.window)

        async def fix(lf: CkptLeaf, stripe: int) -> None:
            async with window:
                content = await self._read_stripe_verified(lay, lf, stripe)
            off = stripe * k * cs
            bufs[lf.path][off:off + len(content)] = content

        await asyncio.gather(*(fix(lf, s) for lf, s in degraded))
        return {lf.path: np.frombuffer(bytes(bufs[lf.path]),
                                       dtype=np.dtype(lf.dtype)
                                       ).reshape(lf.shape)
                for lf in selected}

    async def _read_stripe_verified(self, lay: ECLayout, lf: CkptLeaf,
                                    stripe: int) -> bytes:
        """Degraded/suspect stripe read, CRC-verified against the manifest:
        shards whose stored or device CRC disagrees with the committed one
        are reconstructed from the remaining shards; a stripe that cannot
        be brought to bit-identical committed content raises
        CHECKSUM_MISMATCH rather than returning silently wrong bytes."""
        k, m, cs = lay.k, lay.m, lay.chunk_size
        stripe_len = lf.stripe_len(lay, stripe)
        lens = [max(0, min(cs, stripe_len - j * cs)) for j in range(k)]
        want_crcs = lf.stripe_crcs(lay, stripe)
        tracing.add_event("ckpt.stripe.degraded",
                          f"path={lf.path} stripe={stripe}")
        data, got_crcs = await self.ec.read_stripe_with_crcs(
            lay, lf.inode, stripe, stripe_len)

        def shard(j: int) -> bytes:
            return data[j * cs: j * cs + lens[j]]

        bad = [j for j in range(k) if lens[j]
               and not _crc_ok(got_crcs[j], shard(j), want_crcs[j])]
        if not bad:
            return data
        # stale/corrupt content: treat as LOST and decode from the rest
        log.warning("ckpt restore %r stripe %d: shards %s fail manifest "
                    "CRC, reconstructing", lf.path, stripe, bad)
        zero_shards = frozenset(j for j in range(k) if lens[j] == 0)
        known = {j: shard(j) for j in range(k)
                 if lens[j] and j not in bad}
        rec, rcrcs = await self.ec._reconstruct_shards(
            lay, lf.inode, stripe, tuple(bad), zero_shards, known=known)
        parts = {j: shard(j) for j in range(k) if lens[j]}
        for j, content, crc in zip(bad, rec, rcrcs):
            content = content[: lens[j]]
            crc = crc if lens[j] == cs else None
            if not _crc_ok(crc, content, want_crcs[j]):
                raise make_error(
                    StatusCode.CHECKSUM_MISMATCH,
                    f"ckpt restore {lf.path!r} stripe {stripe} shard {j}: "
                    f"reconstruction does not match the committed CRC")
            parts[j] = content
        return b"".join(parts[j] for j in range(k) if lens[j])

    # --- scrub ---

    async def scrub(self, step: int | None = None, repair: bool = True
                    ) -> ScrubReport:
        """Parity/CRC audit of one checkpoint: verify-only reads of every
        shard (data AND parity) against both the server's stored CRC and
        the manifest's committed CRC; with repair=True, bad shards are
        removed and rebuilt via repair_stripe."""
        manifest = await self.store.load(step)
        lay = manifest.layout
        report = ScrubReport()
        window = asyncio.Semaphore(self.window)

        async def one(lf: CkptLeaf, stripe: int) -> None:
            async with window:
                await self._scrub_stripe(lay, lf, stripe, repair, report)

        await asyncio.gather(*(one(lf, s) for lf in manifest.leaves
                               for s in range(lf.num_stripes)))
        return report

    async def _scrub_stripe(self, lay: ECLayout, lf: CkptLeaf, stripe: int,
                            repair: bool, report: ScrubReport) -> None:
        k, m, cs = lay.k, lay.m, lay.chunk_size
        stripe_len = lf.stripe_len(lay, stripe)
        lens = [max(0, min(cs, stripe_len - j * cs)) for j in range(k)]
        want_crcs = lf.stripe_crcs(lay, stripe)
        ios = []
        for s in range(k + m):
            cid = (lay.data_chunk(lf.inode, stripe, s) if s < k
                   else lay.parity_chunk(lf.inode, stripe, s - k))
            ios.append(ReadIO(chunk_id=cid,
                              chain_id=lay.shard_chain(stripe, s),
                              no_payload=True, verify_checksum=True))
        results, _ = await self.ec._fast.batch_read(ios)
        missing, corrupt = [], []
        for s, r in enumerate(results):
            hole = s < k and lens[s] == 0
            report.shards_checked += 1
            if hole:
                if r.status.code == int(StatusCode.OK):
                    corrupt.append(s)   # a hole shard must be ABSENT
                continue
            if r.status.code == int(StatusCode.CHECKSUM_MISMATCH):
                corrupt.append(s)       # server-side bit rot
            elif r.status.code != int(StatusCode.OK):
                missing.append(s)       # absent or unreachable
            elif int(r.checksum) != want_crcs[s]:
                corrupt.append(s)       # readable but NOT the committed data
        report.shards_missing += len(missing)
        report.shards_corrupt += len(corrupt)
        if not (missing or corrupt) or not repair:
            return
        # a corrupt shard is still READABLE: remove it first so the repair
        # decodes from parity instead of trusting the wrong bytes
        for s in corrupt:
            cid = (lay.data_chunk(lf.inode, stripe, s) if s < k
                   else lay.parity_chunk(lf.inode, stripe, s - k))
            r = await self.ec.sc.write_chunk(
                lay.shard_chain(stripe, s), cid, 0, b"", chunk_size=cs,
                update_type=UpdateType.REMOVE)
            if r.status.code not in (int(StatusCode.OK),
                                     int(StatusCode.CHUNK_NOT_FOUND)):
                # the corrupt shard is still serving reads — repairing
                # around it is fine (it's in `bad`), but leaving it in
                # place silently would mask the failed remove
                log.warning("ckpt scrub %r stripe %d shard %d: remove of "
                            "corrupt shard failed: %s", lf.path, stripe, s,
                            r.status.message)
        bad = tuple(sorted(missing + corrupt))
        try:
            outcomes = await self.ec.repair_stripe(lay, lf.inode, stripe,
                                                   bad, stripe_len)
        except Exception:
            log.exception("ckpt scrub %r stripe %d: repair failed",
                          lf.path, stripe)
            report.stripes_unrecoverable += 1
            return
        report.shards_repaired += sum(
            1 for r in outcomes if r.status.code == int(StatusCode.OK))


def _crc_ok(crc: int | None, content: bytes, want: int) -> bool:
    """Device/stored CRC when available; host crc32c only as the cold
    fallback (trimmed tails, numpy-oracle reconstructions)."""
    if crc is not None:
        return crc == want
    return crc32c(content) == want
