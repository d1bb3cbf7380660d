"""ChunkReplica: the CRAQ chunk state machine over the chunk engine.

Reference analog: storage/store/ChunkReplica.cc — update version gating
(:132-241: committed/stale/missing/advance cases), client-checksum verify
(:193-206), updateChecksum combine-or-recompute (:319-360), commit (:30 in
ChunkReplica.h), read rules (aioPrepareRead :38-130; committed-only serving,
docs/design_notes.md:169-173).

Version semantics:
  commit_ver — highest committed update
  update_ver — highest applied update (== commit_ver when COMMIT, commit_ver+1
               when DIRTY: exactly one update may be pending per chunk because
               the head serializes per-chunk under a lock)
"""

from __future__ import annotations

from t3fs_torch.ops.codec import crc32c, crc32c_combine
from t3fs_torch.ops.crc32c import crc32c_ref  # noqa: F401 (oracle re-export)
from t3fs_torch.storage.chunk_engine import ChunkEngine
from t3fs_torch.storage.types import (
    ChunkId, ChunkMeta, ChunkState, IOResult, ReadIO, UpdateIO, UpdateType,
)
from t3fs_torch.net.wire import WireStatus
from t3fs_torch.utils.status import Status, StatusCode, StatusError, make_error

# pluggable CRC impl (the codec seam; default = fastest host path, which is
# the native SSE4.2 library when built, else the Python reference)
CrcFn = type(crc32c_ref)


class ChunkReplica:
    def __init__(self, engine: ChunkEngine, crc=crc32c, crc_combine=crc32c_combine):
        self.engine = engine
        self.crc = crc
        self.crc_combine = crc_combine

    # --- update path ---

    def apply_update(self, io: UpdateIO, payload: bytes,
                     payload_crc: int | None = None) -> IOResult:
        """Apply one update as DIRTY; raises StatusError on gating violations.
        Idempotent for the retry of the currently-pending update.

        payload_crc: CRC32C of payload precomputed by the node's
        ChecksumBackend (the codec seam — batched device offload); when None
        the replica computes it on the host."""
        meta = self.engine.get_meta(io.chunk_id)

        if io.update_type == UpdateType.REMOVE:
            if io.remove_fence_ver and meta is not None \
                    and meta.update_ver > io.remove_fence_ver:
                # fenced remove (KVCache eviction vs concurrent re-put):
                # the chunk moved past the version the remover verified —
                # the NEWER block must survive.  Versions advance only
                # under the head's per-chunk lock, so this check at the
                # head is authoritative and forwarded hops (which see the
                # same serialized history) agree.
                raise make_error(
                    StatusCode.CHUNK_STALE_UPDATE,
                    f"{io.chunk_id}: remove fenced at v{io.remove_fence_ver}"
                    f", chunk at v{meta.update_ver}")
            if io.is_sync and meta is not None:
                # resync removes are CAS-gated on the snapshot state the
                # worker diffed against: a live write that touched the chunk
                # since (new version, or the in-flight write committed)
                # invalidates the removal — deleting would lose acked data
                # the tail now has (stale-remove race; the sim found it).
                if (meta.update_ver, meta.commit_ver, meta.checksum) != \
                        (io.update_ver, io.commit_ver, io.checksum):
                    return IOResult(WireStatus(), meta.length, meta.update_ver,
                                    meta.commit_ver, meta.chain_ver,
                                    meta.checksum)
            self.engine.remove(io.chunk_id)
            return IOResult(WireStatus(), 0, io.update_ver, io.update_ver, io.chain_ver, 0)

        if io.update_type == UpdateType.REPLACE or io.is_sync:
            # full-chunk-replace (resync / write-during-recovery,
            # design_notes.md:240-246).  Version-MONOTONIC: a replace may
            # never regress a newer chunk — the resync worker snapshots
            # without holding the predecessor's chunk lock, so a stale
            # replace can arrive after a live-forwarded newer one.
            if meta is not None and meta.update_ver > io.update_ver:
                return IOResult(WireStatus(), meta.length, meta.update_ver,
                                meta.commit_ver, meta.chain_ver, meta.checksum)
            if meta is not None and meta.update_ver == io.update_ver \
                    and meta.commit_ver >= io.update_ver \
                    and io.checksum in (0, meta.checksum):
                # same version ALREADY COMMITTED with matching content: a
                # late replace (e.g. a write-forward racing a completed
                # resync of the same version) must be idempotent —
                # re-marking DIRTY would wedge the chunk, since the
                # idempotent commit path would never flip it back.  A
                # DIFFERENT checksum at the same version is divergence
                # (e.g. post-data-loss) and must fall through so the
                # replace actually repairs the bytes.
                return IOResult(WireStatus(), meta.length, meta.update_ver,
                                meta.commit_ver, meta.chain_ver, meta.checksum)
            checksum = payload_crc if payload_crc is not None \
                else self.crc(payload)
            if io.checksum and checksum != io.checksum:
                raise make_error(StatusCode.CHECKSUM_MISMATCH,
                                 f"{io.chunk_id}: replace payload checksum")
            if io.is_sync:
                # resync ships committed state wholesale
                commit_ver = io.commit_ver or io.update_ver
                state = (ChunkState.COMMIT if commit_ver >= io.update_ver
                         else ChunkState.DIRTY)
            else:
                # client-initiated whole-chunk replace still follows the
                # CRAQ commit flow (DIRTY until the chain acks)
                commit_ver = meta.commit_ver if meta else 0
                state = ChunkState.DIRTY
            new = ChunkMeta(io.chunk_id, len(payload), io.update_ver,
                            commit_ver, io.chain_ver, checksum, state)
            self.engine.put(io.chunk_id, payload, new, io.chunk_size or len(payload))
            return IOResult(WireStatus(), new.length, new.update_ver,
                            new.commit_ver, new.chain_ver, new.checksum)

        cur_update = meta.update_ver if meta else 0
        cur_commit = meta.commit_ver if meta else 0
        cur_state = meta.state if meta else ChunkState.COMMIT

        if io.update_ver <= cur_commit:
            if io.update_ver == cur_commit and cur_update == cur_commit:
                # re-delivery of the update this replica already COMMITTED.
                # The tail commits before its predecessors, so a mid-chain
                # failure after the tail committed leaves the head retrying
                # v against a tail already at committed v — rare under the
                # serialized write path, DETERMINISTIC under write
                # pipelining (the successor leg runs concurrently with the
                # failing hop's apply).  Versions uniquely name updates
                # chain-wide (assigned under the head's per-chunk lock,
                # pinned across retries by remember_version), so this is
                # the same update: ack with the committed meta.
                return IOResult(WireStatus(), meta.length, meta.update_ver,
                                meta.commit_ver, meta.chain_ver, meta.checksum)
            # older than committed state: genuinely late duplicate
            raise make_error(StatusCode.CHUNK_STALE_UPDATE,
                             f"{io.chunk_id}: v{io.update_ver} <= committed v{cur_commit}")
        if io.update_ver == cur_update and cur_state == ChunkState.DIRTY:
            # retry of the pending update: idempotent success
            return IOResult(WireStatus(), meta.length, meta.update_ver,
                            meta.commit_ver, meta.chain_ver, meta.checksum)
        if io.update_ver > cur_update + 1:
            raise make_error(StatusCode.CHUNK_MISSING_UPDATE,
                             f"{io.chunk_id}: v{io.update_ver} after v{cur_update}")
        if cur_state == ChunkState.DIRTY and io.update_ver != cur_update + 1:
            # a different pending update exists; caller must retry after
            # commit.  A retry of a FAILED attempt re-enters with its
            # remembered version (ReliableUpdate.remember_version) and takes
            # the idempotent branch above instead of landing here.
            raise make_error(StatusCode.CHUNK_BUSY,
                             f"{io.chunk_id}: pending v{cur_update}")
        # else ADVANCE (the reference's 'advance update' case,
        # design_notes.md:201-231 update table): v = pending+1 SUPERSEDES a
        # dirty pending version.  Safe because versions are assigned under
        # the head's per-chunk lock — v+1 exists only after v's attempt
        # finished at the head, and v+1's content is computed ON TOP of
        # v's bytes, so v's effects remain part of the history (a late
        # retry of v answers BUSY, then STALE once v+1 commits — never a
        # silent divergent ack).  Without this, an update abandoned by its
        # client (bounded retries/crash) wedges the chunk DIRTY on serving
        # replicas forever: the wide craq_sim sweep found exactly that
        # (seeds 100862/101149/...)

        # verify client checksum of the payload (ChunkReplica.cc:193-206)
        if payload_crc is None:
            payload_crc = self.crc(payload)
        if io.checksum and payload_crc != io.checksum:
            raise make_error(StatusCode.CHECKSUM_MISMATCH,
                             f"{io.chunk_id}: payload crc {payload_crc:#x} != {io.checksum:#x}")

        old = self.engine.read(io.chunk_id) if meta else b""

        if io.update_type == UpdateType.TRUNCATE:
            if io.length <= len(old):
                content = old[: io.length]
            else:
                content = old + b"\x00" * (io.length - len(old))
            checksum = self.crc(content)
        else:
            end = io.offset + len(payload)
            if io.offset == len(old):
                # pure append: combine instead of recompute (Common.h:191
                # trick).  join, not +: payload may be a zero-copy RX
                # memoryview (bytes.__add__ rejects those)
                content = b"".join((old, payload))
                old_crc = meta.checksum if meta else 0
                checksum = (self.crc_combine(old_crc, payload_crc, len(payload))
                            if old else payload_crc)
            else:
                content = bytearray(old.ljust(max(len(old), end), b"\x00"))
                content[io.offset:end] = payload
                content = bytes(content)
                checksum = self.crc(content)

        new = ChunkMeta(io.chunk_id, len(content), io.update_ver, cur_commit,
                        io.chain_ver, checksum, ChunkState.DIRTY)
        self.engine.put(io.chunk_id, content, new, io.chunk_size or len(content))
        return IOResult(WireStatus(), new.length, new.update_ver, new.commit_ver,
                        new.chain_ver, new.checksum)

    def commit(self, chunk_id: ChunkId, update_ver: int, chain_ver: int) -> IOResult:
        """Flip DIRTY->COMMIT for update_ver (idempotent)."""
        meta = self.engine.get_meta(chunk_id)
        if meta is None:
            # REMOVE ops never reach here (the service skips engine commit
            # for them, service.py:376; the reference threads is_remove to
            # the same effect, chunk_engine/src/core/engine.rs:376), and
            # the head's per-chunk lock means no later op can have deleted
            # the chunk mid-update — so a missing chunk at commit means
            # THIS REPLICA LOST THE APPLIED DATA (crash between apply and
            # commit that wiped state).  Acking would erase an acked
            # write with zero physical copies; fail so the head retries
            # the whole write (CHUNK_NOT_FOUND is retryable).  Found by a
            # craq_sim sweep: crash-wipe of the only serving replica
            # between apply and commit, seed 903689.
            raise make_error(StatusCode.CHUNK_NOT_FOUND,
                             f"{chunk_id}: commit v{update_ver} but the "
                             f"chunk is gone (data lost before commit)")
        if meta.commit_ver >= update_ver:
            if meta.state == ChunkState.DIRTY \
                    and meta.update_ver <= meta.commit_ver:
                # defense in depth: a DIRTY marker at/below the committed
                # version is a stale artifact — repair it so reads resume
                meta.state = ChunkState.COMMIT
                self.engine.set_meta(chunk_id, meta)
            return IOResult(WireStatus(), meta.length, meta.update_ver,
                            meta.commit_ver, meta.chain_ver, meta.checksum)
        if meta.update_ver != update_ver:
            raise make_error(StatusCode.CHUNK_MISSING_UPDATE,
                             f"{chunk_id}: commit v{update_ver} but applied v{meta.update_ver}")
        meta.commit_ver = update_ver
        meta.chain_ver = max(meta.chain_ver, chain_ver)
        meta.state = ChunkState.COMMIT
        self.engine.set_meta(chunk_id, meta)
        return IOResult(WireStatus(), meta.length, meta.update_ver,
                        meta.commit_ver, meta.chain_ver, meta.checksum)

    # --- read path ---

    # Shared skeleton of the optimistic read protocol: reads run
    # concurrently with the update worker (no chunk lock), so the meta is
    # re-checked after the data fetch and the attempt retried if an update
    # slipped between them — the returned bytes always pair with the
    # returned versions/checksum.

    def _read_meta_checked(self, io: ReadIO, meta_hint, attempt):
        meta = meta_hint if attempt == 0 and meta_hint is not None \
            else self.engine.get_meta(io.chunk_id)
        if meta is None:
            raise make_error(StatusCode.CHUNK_NOT_FOUND, str(io.chunk_id))
        if meta.state == ChunkState.DIRTY and not io.allow_uncommitted:
            # only committed versions are served (design_notes.md:169-173);
            # client retries — commit latency is one chain round trip
            raise make_error(StatusCode.CHUNK_BUSY,
                             f"{io.chunk_id}: uncommitted v{meta.update_ver}")
        return meta

    @staticmethod
    def _meta_unchanged(meta, meta2) -> bool:
        return meta2 is not None \
            and meta2.update_ver == meta.update_ver \
            and meta2.checksum == meta.checksum \
            and meta2.length == meta.length

    def _read_finish(self, io: ReadIO, meta, data) -> tuple[IOResult, bytes]:
        if io.verify_checksum and io.offset == 0 and len(data) == meta.length:
            actual = self.crc(data)
            if actual != meta.checksum:
                raise make_error(StatusCode.CHECKSUM_MISMATCH,
                                 f"{io.chunk_id}: stored {meta.checksum:#x} != read {actual:#x}")
        return IOResult(WireStatus(), len(data), meta.update_ver, meta.commit_ver,
                        meta.chain_ver, meta.checksum), data

    def read(self, io: ReadIO,
             meta_hint: "ChunkMeta | None" = None) -> tuple[IOResult, bytes]:
        # meta_hint lets the caller reuse a meta it already fetched
        # (sizing decisions) instead of a second lookup
        for attempt in range(8):
            meta = self._read_meta_checked(io, meta_hint, attempt)
            data = self.engine.read(io.chunk_id, io.offset,
                                    io.length if io.length else -1, meta)
            meta2 = self.engine.get_meta(io.chunk_id)
            if self._meta_unchanged(meta, meta2):
                # commit_ver/state may have advanced; report newest
                return self._read_finish(io, meta2, data)
        raise make_error(StatusCode.CHUNK_BUSY,
                         f"{io.chunk_id}: update storm during read")

    async def read_aio(self, io: ReadIO, aio,
                       meta_hint: "ChunkMeta | None" = None
                       ) -> tuple[IOResult, bytes]:
        """read() with the disk pread submitted through the io_uring worker
        (AioReadWorker) instead of the engine's locked pread.  The aio read
        holds NO engine lock, so validation is locate -> pread -> locate:
        the post-read locate must return the SAME allocation generation
        (Slot::gen — a put/remove/recreate bumps it, closing the ABA where
        a recreated chunk reproduces identical meta on a reused block) and
        the meta must be unchanged.  Falls back to the locked thread-pool
        read when the engine can't locate or the aio worker errors."""
        import asyncio as _a

        locate = getattr(self.engine, "locate", None)
        for attempt in range(8):
            meta = self._read_meta_checked(io, meta_hint, attempt)
            loc = locate(io.chunk_id, io.offset,
                         io.length if io.length else meta.length) \
                if locate is not None else None
            if loc is None:
                return await _a.to_thread(self.read, io, meta_hint)
            fd, abs_off, n, gen = loc
            try:
                data = await aio.submit_read(fd, abs_off, n) if n else b""
            except OSError:
                # ring dead/full: self-heal onto the thread pipeline
                return await _a.to_thread(self.read, io, meta_hint)
            meta2 = self.engine.get_meta(io.chunk_id)
            loc2 = locate(io.chunk_id, io.offset,
                          io.length if io.length else meta.length)
            if self._meta_unchanged(meta, meta2) and loc2 is not None \
                    and loc2[3] == gen and len(data) == n:
                return self._read_finish(io, meta2, data)
        raise make_error(StatusCode.CHUNK_BUSY,
                         f"{io.chunk_id}: update storm during read")
