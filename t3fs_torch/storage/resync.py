"""ResyncWorker: bring SYNCING chain members up to date.

Reference analog: storage/sync/ResyncWorker.{h,cc} — for each local target
whose successor is syncing: syncStart pulls the successor's chunk-meta dump
(:101-180), diff by version/checksum rules (docs/design_notes.md:262-270),
stream full-chunk-replace writes (:389+), then syncDone (:358-376).

Concurrent client writes during resync are safe because the live write path
already ships full-chunk REPLACEs to SYNCING successors (service._forward),
and REPLACE application is version-idempotent.

The port of t3fs/storage/resync.py: each REPLACE is checked on the
successor by its checksum backend (B1 on the card for payloads at or above
the backend's device cutoff).
"""

from __future__ import annotations

import asyncio
import logging

from t3fs_torch.mgmtd.types import ChainInfo, ChainTargetInfo
from t3fs_torch.storage.chunk_engine import size_class_of
from t3fs_torch.storage.types import (
    ChunkState, SyncDoneReq, SyncStartReq, UpdateIO, UpdateType,
)
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.status import StatusCode, StatusError

log = logging.getLogger("t3fs_torch.storage.resync")


class ResyncWorker:
    def __init__(self, node, period_s: float = 0.2):
        self.node = node  # StorageNode
        self.period_s = period_s
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()
        self.completed: int = 0   # test observability
        # what the successful pushes sent: full-chunk REPLACEs (chunks and
        # payload bytes) and CAS REMOVEs
        self.replaced_chunks = 0
        self.replaced_bytes = 0
        self.removed_chunks = 0

    async def start(self) -> None:
        # clear, not assume-fresh: stop/start cycles (tests pause the
        # pusher to hold a successor in SYNCING) must actually restart
        self._stopped.clear()
        self._task = asyncio.create_task(self._loop(), name="resync-worker")

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "resync worker")

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.period_s)
            try:
                await self.tick()
            except Exception:
                log.exception("resync tick failed")

    async def tick(self) -> None:
        routing = self.node.routing()
        for chain in routing.chains.values():
            target = self.node._target_for_chain(chain)
            if target is None:
                continue
            serving = chain.serving()
            if not serving or serving[-1].target_id != target.target_id:
                continue  # only the last serving target pushes
            # resyncs run serially on this worker task; re-runs after failure
            # or chain-version bumps are harmless (replace is version-gated)
            for succ in chain.syncing():
                try:
                    await self.resync_target(chain, target, succ)
                    self.completed += 1
                except StatusError as e:
                    log.warning("resync of t%d failed: %s", succ.target_id, e)

    async def resync_target(self, chain: ChainInfo, target,
                            succ: ChainTargetInfo) -> None:
        node = self.node
        routing = node.routing()
        address = routing.node_address(succ.node_id)
        rsp, _ = await node.client.call(address, "Storage.sync_start",
                                        SyncStartReq(chain_id=chain.chain_id))
        remote = {m.chunk_id: m for m in rsp.metas}
        local_all = {m.chunk_id: m for m in target.engine.all_metas()}
        # DIRTY chunks have a write in flight: the live write path is already
        # full-replace-forwarding them to syncing successors, so resync skips
        # them (and must NOT treat them as deleted below)
        local = {cid: m for cid, m in local_all.items()
                 if m.state == ChunkState.COMMIT}

        # transfer rules (design_notes.md:262-270): replace when missing or
        # version/checksum diverges; remove chunks the successor has extra
        for cid, lm in local.items():
            rm = remote.get(cid)
            if rm is not None and rm.update_ver == lm.update_ver \
                    and rm.checksum == lm.checksum \
                    and rm.commit_ver >= lm.commit_ver:
                continue
            # re-fetch the meta at SEND time: a write may have landed since
            # the diff snapshot, and sending the old checksum with the new
            # content trips the successor's payload verification
            lm = target.engine.get_meta(cid)
            if lm is None or lm.state != ChunkState.COMMIT:
                continue  # now gone or write-in-flight: live path covers it
            content = target.engine.read(cid)
            io = UpdateIO(
                chunk_id=cid, chain_id=chain.chain_id, chain_ver=chain.chain_ver,
                update_type=UpdateType.REPLACE, offset=0, length=lm.length,
                chunk_size=size_class_of(max(lm.length, 1)),
                update_ver=lm.update_ver, commit_ver=lm.commit_ver,
                checksum=lm.checksum, is_sync=True, from_head=True, inline=True)
            rsp2, _ = await node.client.call(address, "Storage.update", io,
                                             payload=content)
            if rsp2.result.status.code != int(StatusCode.OK):
                raise StatusError(StatusCode(rsp2.result.status.code),
                                  f"replace {cid}: {rsp2.result.status.message}")
            self.replaced_chunks += 1
            self.replaced_bytes += len(content)
        for cid in remote:
            if cid not in local_all:   # truly absent locally (not just DIRTY)
                # re-check at SEND time: a live write may have CREATED the
                # chunk here since the diff snapshot (and full-replace-
                # forwarded it to the successor) — removing it there would
                # delete acked data
                if target.engine.get_meta(cid) is not None:
                    continue
                rm = remote[cid]
                # CAS remove: carries the snapshot state; the successor only
                # removes if its chunk still matches exactly (a racing live
                # write invalidates the stale removal — replica gating)
                io = UpdateIO(chunk_id=cid, chain_id=chain.chain_id,
                              chain_ver=chain.chain_ver,
                              update_type=UpdateType.REMOVE,
                              update_ver=rm.update_ver,
                              commit_ver=rm.commit_ver, checksum=rm.checksum,
                              is_sync=True, from_head=True, inline=True)
                rsp3, _ = await node.client.call(address, "Storage.update", io)
                if rsp3.result.status.code != int(StatusCode.OK):
                    raise StatusError(StatusCode(rsp3.result.status.code),
                                      f"remove {cid}: {rsp3.result.status.message}")
                self.removed_chunks += 1
        await node.client.call(address, "Storage.sync_done",
                               SyncDoneReq(chain_id=chain.chain_id))
        log.info("resync of t%d on chain %d complete (%d local chunks)",
                 succ.target_id, chain.chain_id, len(local))
