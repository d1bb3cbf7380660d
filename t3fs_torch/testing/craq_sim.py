"""Deterministic-schedule simulation of the CRAQ chain protocol.

Reference analog: specs/DataStorage — the P model checking of the write
protocol under process crashes and unreliable failure detection
(PSrc: MgmtService/StorageService/StorageClient, PSpec/SystemSpec.p
invariants, 10+ schedules in specs/README.md).  Where the reference checks
an ABSTRACT model, this simulator drives the REAL per-replica state machine
(storage.chunk_replica.ChunkReplica over the real chunk engine) and the
REAL membership transition function (mgmtd.service.next_chain_state); only
the RPC fabric is replaced by explicitly scheduled steps, so every
interleaving of apply/forward/commit/crash/mgmtd-tick/resync the scheduler
picks is one the asyncio services could execute.

A schedule = (seed, crash budget).  The scheduler repeatedly picks one
enabled step with a seeded RNG; after the budget is spent it lets the
system quiesce, then checks the invariants:

  I1 convergence: all SERVING replicas byte-identical per chunk
                  (content, commit_ver, checksum)
  I2 durability:  every ACKED write is reflected at version >= its
                  update_ver on every serving replica of its chunk
  I3 monotonicity: no replica ever regresses commit_ver
  I4 read-committed: a committed read during the run never returns data
                  that was never part of an applied update prefix

The port of t3fs/testing/craq_sim.py, a copy with its imports re-pointed:
it drives the port's ChunkReplica, ChunkEngine and next_chain_state, and
a seed gives the same schedule and end state in both packages.
"""

from __future__ import annotations

import os
import random
import tempfile
from dataclasses import dataclass, field

from t3fs_torch.mgmtd.service import next_chain_state
from t3fs_torch.mgmtd.types import (
    ChainInfo, ChainTargetInfo, LocalTargetState, PublicTargetState,
)
from t3fs_torch.storage.chunk_engine import ChunkEngine, size_class_of
from t3fs_torch.storage.chunk_replica import ChunkReplica
from t3fs_torch.storage.types import (
    ChunkId, ChunkState, UpdateIO, UpdateType,
)
from t3fs_torch.utils.status import StatusCode, StatusError

CHUNK_SIZE = 4096


@dataclass
class SimNode:
    node_id: int
    target_id: int
    engine: ChunkEngine
    replica: ChunkReplica
    alive: bool = True
    disk_ok: bool = True          # False: disk failed (node alive, data gone)
    local_state: LocalTargetState = LocalTargetState.UPTODATE
    max_commit_seen: dict[bytes, int] = field(default_factory=dict)
    disk_epoch: int = 0           # bumped on every data loss (wipe/replace)
    # heartbeat "virgin disk" flag: True from wipe/replace until a resync
    # completes (sync_done) or the empty target legitimately seeds a cold
    # chain — the product derives it from the engine booting on an empty
    # data dir (no WAL/meta) and clears it the same way
    disk_fresh: bool = False

    def wipe(self) -> None:
        """Disk loss on crash-restart (worst case)."""
        for m in self.engine.all_metas():
            self.engine.remove(m.chunk_id)
        self.disk_epoch += 1
        self.disk_fresh = True


@dataclass
class WriteOp:
    """One client write: may be retried as multiple attempts."""
    ver: int                      # update_ver assigned by the client sequence
    chunk: ChunkId
    data: bytes
    acked: bool = False
    applied_somewhere: bool = False   # any replica ever accepted an apply
    failed_attempts: int = 0
    attempt_chain_ver: int = 0    # routing version the attempt started on
    # in-flight attempt state: list of (phase, node_index) steps remaining
    steps: list[tuple[str, int]] = field(default_factory=list)
    serving_snapshot: list[int] = field(default_factory=list)  # target ids


class CraqSim:
    def __init__(self, seed: int, *, replicas: int = 3, writes: int = 6,
                 crashes: int = 1, chunks: int = 2, wipe_on_crash: bool = False,
                 mgmtd_restarts: int = 0, disk_fails: int = 0):
        self.rng = random.Random(seed)
        self.seed = seed
        self.tmp = tempfile.TemporaryDirectory(prefix="craq-sim-")
        self.nodes: dict[int, SimNode] = {}
        targets = []
        for i in range(1, replicas + 1):
            engine = ChunkEngine(os.path.join(self.tmp.name, f"n{i}"))
            self.nodes[100 + i] = SimNode(
                node_id=i, target_id=100 + i, engine=engine,
                replica=ChunkReplica(engine))
            targets.append(ChainTargetInfo(100 + i, i,
                                           PublicTargetState.SERVING))
        self.chain = ChainInfo(chain_id=1, chain_ver=1, targets=targets)
        self.chunks = [ChunkId(inode=7, index=i) for i in range(chunks)]
        self.writes_total = writes
        self.crash_budget = crashes
        self.wipe_on_crash = wipe_on_crash
        self.next_ver: dict[bytes, int] = {c.encode(): 0 for c in self.chunks}
        self.pending: list[WriteOp] = []
        self.done: list[WriteOp] = []
        # (chunk_bytes, ver) -> {(target_id, disk_epoch)} at commit time
        self.commit_copies: dict[tuple, set] = {}
        # chunk_bytes -> highest committed ver whose sole authoritative
        # serving copy was destroyed (legitimate loss horizon)
        self.authority_lost: dict[bytes, int] = {}
        self.resync_inflight: dict[int, list] = {}   # succ target -> steps
        # generation-change detection (heartbeat NodeInfo.generation):
        # restarted targets must be demoted from SERVING even if the crash
        # fit inside the heartbeat window.  The manager persists a node's
        # generation ATOMICALLY with the demotions it implies (service.py
        # pending_node_saves), so detection survives a mgmtd restart — the
        # sim models this as persisted per-node generations; the in-memory
        # restart flags are recomputed every tick from the gen mismatch.
        self.node_gen: dict[int, int] = {n.node_id: 0
                                         for n in self.nodes.values()}
        self.node_gen_persisted: dict[int, int] = dict(self.node_gen)
        self.mgmtd_restart_budget = mgmtd_restarts
        self.disk_fail_budget = disk_fails
        # startup grace after a mgmtd restart: empty liveness map == treat
        # everyone as alive for a window (MgmtdState.started_at analog)
        self.mgmtd_grace_ticks = 0
        self.violations: list[str] = []
        # expected chunk content after each version — deterministic because
        # versions are assigned sequentially per chunk at launch time
        # (merge semantics of offset-0 writes: new data over old tail)
        self.expected: dict[bytes, dict[int, bytes]] = {
            c.encode(): {0: b""} for c in self.chunks}

    # ---- helpers ----

    def node_of_target(self, target_id: int) -> SimNode:
        return self.nodes[target_id]

    def serving_targets(self) -> list[int]:
        return [t.target_id for t in self.chain.serving()]

    def launch_write(self) -> None:
        chunk = self.rng.choice(self.chunks)
        key = chunk.encode()
        ver = self.next_ver[key] + 1
        self.next_ver[key] = ver
        data = bytes([ver & 0xFF]) * self.rng.choice([64, 256, CHUNK_SIZE])
        prev = self.expected[key][ver - 1]
        self.expected[key][ver] = data + prev[len(data):]
        op = WriteOp(ver=ver, chunk=chunk, data=data)
        self._start_attempt(op)
        self.pending.append(op)

    def _start_attempt(self, op: WriteOp) -> None:
        serving = self.serving_targets()
        op.serving_snapshot = list(serving)
        op.attempt_chain_ver = self.chain.chain_ver
        # CRAQ write traverses serving head -> tail, plus full-replace
        # forwarding into syncing members (service._forward analog)
        hop_targets = serving + [t.target_id for t in self.chain.syncing()]
        if not serving:
            # no serving HEAD: the product refuses the write outright
            # (_check_chain require_head -> TARGET_OFFLINE) — a hop list
            # of syncing-only members would ack a write that never touched
            # an authoritative copy (wide-sweep seeds 400025/400203)
            op.steps = [("wait", 0)]
            return
        op.steps = ([("apply", t) for t in hop_targets]
                    + [("commit", t) for t in reversed(hop_targets)]
                    + [("ack", 0)])

    # ---- schedulable actions ----

    def _head_serialized(self) -> list:
        """The head holds the per-chunk lock across the WHOLE chain update
        (apply -> forward -> commit, service._handle_update_inner), so at
        most ONE update per chunk is chain-inflight: only the lowest
        pending version per chunk may step.  (Without this gate the sim
        interleaves two live updates' hops — a schedule the product cannot
        produce — and the replica ADVANCE rule would be unsound.)"""
        lowest: dict[bytes, "WriteOp"] = {}
        for op in self.pending:
            k = op.chunk.encode()
            if k not in lowest or op.ver < lowest[k].ver:
                lowest[k] = op
        return [op for op in lowest.values() if op.steps]

    def enabled_actions(self) -> list[tuple]:
        acts: list[tuple] = []
        for op in self._head_serialized():
            acts.append(("write_step", op))
        if len(self.done) + len(self.pending) < self.writes_total:
            acts.append(("launch_write", None))
        if self.crash_budget > 0:
            for n in self.nodes.values():
                if n.alive:
                    acts.append(("crash", n))
        for n in self.nodes.values():
            if not n.alive:
                acts.append(("restart", n))
        acts.append(("mgmtd_tick", None))
        if self.mgmtd_restart_budget > 0:
            acts.append(("mgmtd_restart", None))
        if self.disk_fail_budget > 0:
            for n in self.nodes.values():
                if n.alive and n.disk_ok:
                    acts.append(("disk_fail", n))
        for n in self.nodes.values():
            if not n.disk_ok and self._replace_allowed(n):
                acts.append(("disk_replace", n))
        for succ in list(self.resync_inflight):
            acts.append(("resync_step", succ))
        self._maybe_enable_resync(acts)
        # committed reads act as I4 probes
        serving = self.serving_targets()
        if serving:
            acts.append(("read", self.rng.choice(serving)))
        return acts

    def _maybe_enable_resync(self, acts: list) -> None:
        serving = self.chain.serving()
        if not serving:
            return
        tail = serving[-1]
        tnode = self.node_of_target(tail.target_id)
        if not tnode.alive or not tnode.disk_ok:
            return
        for succ in self.chain.syncing():
            snode = self.node_of_target(succ.target_id)
            if succ.target_id not in self.resync_inflight \
                    and snode.alive and snode.disk_ok:
                acts.append(("resync_start", (tail.target_id, succ.target_id)))

    def step(self) -> bool:
        acts = self.enabled_actions()
        if not acts:
            return False
        kind, arg = self.rng.choice(acts)
        getattr(self, f"_do_{kind}")(arg)
        return True

    # ---- action implementations ----

    def _do_launch_write(self, _arg) -> None:
        self.launch_write()

    def _do_write_step(self, op: WriteOp) -> None:
        phase, target_id = op.steps[0]
        if phase == "wait":
            # parked until the chain has members again (not a retry: zero
            # availability is not livelock)
            if self.serving_targets() or self.chain.syncing():
                self._start_attempt(op)
            return
        if phase == "ack":
            op.steps.pop(0)
            op.acked = True
            self.pending.remove(op)
            self.done.append(op)
            return
        if self.chain.chain_ver != op.attempt_chain_ver:
            # chain-version gating (_check_chain CHAIN_VERSION_MISMATCH):
            # an attempt started on an older routing epoch fails wholesale;
            # the client refreshes and retries
            self._retry(op)
            return
        node = self.nodes.get(target_id)
        tinfo = next((t for t in self.chain.targets
                      if t.target_id == target_id), None)
        in_chain = tinfo is not None and tinfo.public_state in (
            PublicTargetState.SERVING, PublicTargetState.SYNCING)
        if node is None or not node.alive or not node.disk_ok \
                or not in_chain:
            # RPC/disk error at this hop; the attempt waits — until mgmtd
            # publishes a new chain version, retrying the same membership
            # is pointless (StorageClientImpl backoff)
            return
        try:
            if phase == "apply":
                if tinfo.public_state == PublicTargetState.SYNCING:
                    # write-during-recovery: full-chunk replace
                    # (service._forward REPLACE analog)
                    content = self._expected_content_after(op)
                    io = UpdateIO(chunk_id=op.chunk, chain_id=1,
                                  chain_ver=self.chain.chain_ver,
                                  update_type=UpdateType.REPLACE,
                                  offset=0, length=len(content),
                                  chunk_size=size_class_of(CHUNK_SIZE),
                                  update_ver=op.ver, commit_ver=0,
                                  inline=True)
                    node.replica.apply_update(io, content)
                else:
                    io = UpdateIO(chunk_id=op.chunk, chain_id=1,
                                  chain_ver=self.chain.chain_ver,
                                  update_type=UpdateType.WRITE,
                                  offset=0, length=len(op.data),
                                  chunk_size=size_class_of(CHUNK_SIZE),
                                  update_ver=op.ver, inline=True)
                    node.replica.apply_update(io, op.data)
            else:  # commit
                node.replica.commit(op.chunk, op.ver, self.chain.chain_ver)
                self._note_commit(node, op.chunk)
            if phase == "apply":
                op.applied_somewhere = True
            op.steps.pop(0)
        except StatusError as e:
            if e.code == StatusCode.CHUNK_STALE_UPDATE:
                op.steps.pop(0)   # already applied+committed: idempotent ok
            elif e.code == StatusCode.CHUNK_BUSY:
                # another write holds the chunk pending: the real head
                # WAITS on the per-chunk lock — stay at this step
                pass
            elif e.code == StatusCode.CHUNK_MISSING_UPDATE and phase == "apply" \
                    and op.serving_snapshot \
                    and target_id != op.serving_snapshot[0]:
                # successor missed earlier updates (promoted mid-resync):
                # predecessor falls back to full-chunk forwarding
                # (service._forward MISSING fallback / doForward analog)
                content = self._expected_content_after(op)
                io = UpdateIO(chunk_id=op.chunk, chain_id=1,
                              chain_ver=self.chain.chain_ver,
                              update_type=UpdateType.REPLACE, offset=0,
                              length=len(content),
                              chunk_size=size_class_of(CHUNK_SIZE),
                              update_ver=op.ver, commit_ver=0, inline=True)
                node.replica.apply_update(io, content)
                op.steps.pop(0)
            elif e.code == StatusCode.CHUNK_MISSING_UPDATE:
                self._retry(op)
            elif e.code == StatusCode.CHUNK_NOT_FOUND and phase == "commit":
                # replica lost the applied chunk before commit (crash
                # wipe): the client retries the whole write, re-applying
                # the data — never ack over zero copies
                self._retry(op)
            else:
                self.violations.append(
                    f"unexpected status in {phase}@t{target_id} "
                    f"w{op.ver}: {e}")
                self._retry(op)

    def _expected_content_after(self, op: WriteOp) -> bytes:
        """Full-chunk content a REPLACE forward carries: the predecessor's
        post-apply content at op.ver (deterministic by version sequence)."""
        return self.expected[op.chunk.encode()][op.ver]

    def _retry(self, op: WriteOp) -> None:
        # (zero-membership unavailability never reaches here: those ops
        # park on a 'wait' step in _start_attempt instead of retrying)
        op.failed_attempts += 1
        if op.failed_attempts > 1000:
            # the client gives up (bounded retries, like the product's
            # StorageClient).  This is NOT itself a violation: an
            # abandoned partial apply must be absorbed by the replica
            # ADVANCE rule, and any real wedge it leaves shows up as drain
            # non-convergence or an I1/I2 failure.  (The sim's fixed
            # client-side version numbering can also leave unfillable
            # version holes after legitimate authority loss, where the
            # product's head would simply re-assign from its post-loss
            # meta — another reason abandonment must be clean.)
            self.pending.remove(op)
            self.done.append(op)
            return
        self._start_attempt(op)

    def _do_crash(self, node: SimNode) -> None:
        self.crash_budget -= 1
        node.alive = False
        if self.wipe_on_crash:
            node.wipe()
        if node.disk_ok:
            node.local_state = LocalTargetState.ONLINE  # stale until resync
        # else: the dead disk stays OFFLINE through the crash
        self.resync_inflight.pop(node.target_id, None)

    def _do_restart(self, node: SimNode) -> None:
        node.alive = True
        # reference semantics: a restarted target reports ONLINE (data
        # possibly stale) until resync marks it UPTODATE; the next heartbeat
        # carries a new generation, flagging the restart to mgmtd.  A node
        # booting on a dead disk keeps reporting OFFLINE.
        node.local_state = (LocalTargetState.ONLINE if node.disk_ok
                            else LocalTargetState.OFFLINE)
        self.node_gen[node.node_id] += 1

    def _replace_allowed(self, node: SimNode) -> bool:
        """Operator rule (remove_target/create_target gating): a disk swap
        only happens after mgmtd pulled the target out of the live chain —
        swapping a still-SERVING/LASTSRV target would seat an empty disk as
        an authoritative copy."""
        t = next((t for t in self.chain.targets
                  if t.target_id == node.target_id), None)
        return t is not None and t.public_state in (
            PublicTargetState.OFFLINE, PublicTargetState.WAITING)

    def _do_disk_fail(self, node: SimNode) -> None:
        """Disk dies under a live node: the node detects it (write error /
        CheckWorker probe) and reports local OFFLINE in heartbeats
        (StorageOperator.cc:604-606 + worker/CheckWorker analog)."""
        self.disk_fail_budget -= 1
        # AUTHORITY loss: if this target is the only serving member, the
        # linearized history's sole authoritative copy burns with it.
        # Returning crashed nodes are formally stale and resync will
        # correctly discard their data (full-replace from the serving
        # chain, design_notes.md:240-246 — the reference does the same),
        # so acked writes up to this target's committed versions are
        # legitimately lost, not a protocol violation.
        others = [t for t in self.chain.serving()
                  if t.target_id != node.target_id]
        mine = next((t for t in self.chain.targets
                     if t.target_id == node.target_id), None)
        if not others and mine is not None and mine.public_state in (
                PublicTargetState.SERVING, PublicTargetState.LASTSRV):
            for ck, cv in node.max_commit_seen.items():
                self.authority_lost[ck] = max(
                    self.authority_lost.get(ck, -1), cv)
        node.disk_ok = False
        node.local_state = LocalTargetState.OFFLINE
        self.resync_inflight.pop(node.target_id, None)

    def _do_disk_replace(self, node: SimNode) -> None:
        """Operator replaces the disk (create_target): empty data, local
        ONLINE; mgmtd re-seats the target as SYNCING and resync refills."""
        node.wipe()
        node.disk_ok = True
        node.local_state = LocalTargetState.ONLINE

    def _do_mgmtd_restart(self, _arg) -> None:
        """The MANAGER restarts: all in-memory liveness/restart tracking is
        gone; persisted chains + node generations survive.  For a grace
        window the new primary treats every node as alive (started_at
        analog) — safety must hold through the delayed failure detection."""
        self.mgmtd_restart_budget -= 1
        self.mgmtd_grace_ticks = 2

    def _do_mgmtd_tick(self, _arg) -> None:
        alive = {n.node_id: n.alive for n in self.nodes.values()}
        if self.mgmtd_grace_ticks > 0:
            self.mgmtd_grace_ticks -= 1
            alive = {nid: True for nid in alive}
        local = {n.target_id: n.local_state for n in self.nodes.values()}
        # restart flags derive from persisted-vs-current generation, exactly
        # like the heartbeat handler (detection survives mgmtd restarts)
        restarted = {n.target_id for n in self.nodes.values()
                     if self.node_gen[n.node_id]
                     != self.node_gen_persisted[n.node_id]}
        fresh = {n.target_id for n in self.nodes.values() if n.disk_fresh}
        new = next_chain_state(self.chain, alive, local,
                               restarted=restarted, fresh=fresh)
        if new is not None:
            # an empty target that legitimately SEEDED a cold chain is
            # the authority now: its (empty) content IS the lineage
            for t in new.targets:
                if t.public_state == PublicTargetState.SERVING:
                    self.node_of_target(t.target_id).disk_fresh = False
        # generation persisted atomically with the (possibly empty) chain
        # save — mirrors update_chains_once's single-transaction behavior
        for n in self.nodes.values():
            if n.target_id in restarted:
                self.node_gen_persisted[n.node_id] = self.node_gen[n.node_id]
        if new is not None:
            self.chain = new

    def _do_resync_start(self, pair) -> None:
        tail_t, succ_t = pair
        tail = self.node_of_target(tail_t)
        succ = self.node_of_target(succ_t)
        remote = {m.chunk_id.encode(): m for m in succ.engine.all_metas()}
        local_all = {m.chunk_id.encode(): m for m in tail.engine.all_metas()}
        local = {k: m for k, m in local_all.items()
                 if m.state == ChunkState.COMMIT}
        steps: list[tuple] = []
        for key, lm in local.items():
            rm = remote.get(key)
            if rm is not None and rm.update_ver == lm.update_ver \
                    and rm.checksum == lm.checksum \
                    and rm.commit_ver >= lm.commit_ver:
                continue
            steps.append(("replace", tail_t, lm.chunk_id, lm.update_ver,
                          lm.commit_ver, lm.checksum))
        for key, rm in remote.items():
            if key not in local_all:
                steps.append(("remove", tail_t, rm.chunk_id,
                              rm.update_ver, rm.commit_ver, rm.checksum))
        steps.append(("sync_done", tail_t, None, 0, 0, 0))
        self.resync_inflight[succ_t] = steps

    def _do_resync_step(self, succ_t: int) -> None:
        steps = self.resync_inflight.get(succ_t)
        if not steps:
            self.resync_inflight.pop(succ_t, None)
            return
        succ_node = self.node_of_target(succ_t)
        tinfo = next((t for t in self.chain.targets
                      if t.target_id == succ_t), None)
        if not succ_node.alive or not succ_node.disk_ok or tinfo is None \
                or tinfo.public_state != PublicTargetState.SYNCING:
            self.resync_inflight.pop(succ_t, None)  # aborted; retried later
            return
        kind, tail_t, chunk_id, uver, cver, crc = steps.pop(0)
        tail = self.node_of_target(tail_t)
        if not tail.alive or not tail.disk_ok:
            self.resync_inflight.pop(succ_t, None)
            return
        try:
            if kind == "replace":
                # re-fetch meta at send time (resync_target analog): the
                # diff snapshot may be stale after a concurrent write
                lm = tail.engine.get_meta(chunk_id)
                if lm is None or lm.state != ChunkState.COMMIT:
                    return  # live write path covers it
                uver, cver, crc = lm.update_ver, lm.commit_ver, lm.checksum
                content = tail.engine.read(chunk_id)
                io = UpdateIO(chunk_id=chunk_id, chain_id=1,
                              chain_ver=self.chain.chain_ver,
                              update_type=UpdateType.REPLACE, offset=0,
                              length=len(content),
                              chunk_size=size_class_of(CHUNK_SIZE),
                              update_ver=uver, commit_ver=cver, checksum=crc,
                              is_sync=True, inline=True)
                succ_node.replica.apply_update(io, content)
                self._note_commit(succ_node, chunk_id)
            elif kind == "remove":
                if tail.engine.get_meta(chunk_id) is not None:
                    return  # live write created it since the snapshot
                io = UpdateIO(chunk_id=chunk_id, chain_id=1,
                              chain_ver=self.chain.chain_ver,
                              update_type=UpdateType.REMOVE,
                              update_ver=uver, commit_ver=cver, checksum=crc,
                              is_sync=True, inline=True)
                succ_node.replica.apply_update(io, b"")
            else:  # sync_done
                succ_node.local_state = LocalTargetState.UPTODATE
                succ_node.disk_fresh = False   # now holds the real lineage
                self.resync_inflight.pop(succ_t, None)
        except StatusError as e:
            self.violations.append(f"resync {kind} t{succ_t}: {e}")
            self.resync_inflight.pop(succ_t, None)

    def _do_read(self, target_id: int) -> None:
        """Committed read as I4 probe: returned bytes must be SOME applied
        write's content (or empty)."""
        node = self.nodes.get(target_id)
        if node is None or not node.alive or not node.disk_ok:
            return
        chunk = self.rng.choice(self.chunks)
        meta = node.engine.get_meta(chunk)
        if meta is None or meta.state != ChunkState.COMMIT:
            return  # service would bounce with CHUNK_BUSY/NOT_FOUND
        data = node.engine.read(chunk)
        valid = set(self.expected[chunk.encode()].values())
        if data not in valid:
            self.violations.append(
                f"I4: read of {chunk} on t{target_id} returned bytes of no "
                f"applied version (len={len(data)})")

    def _note_commit(self, node: SimNode, chunk: ChunkId) -> None:
        meta = node.engine.get_meta(chunk)
        if meta is None:
            return
        # durability ledger: which physical disk (target, epoch) committed
        # this version — the lost-acked-write invariant excuses a loss only
        # when EVERY committed copy's disk later died (redundancy burned;
        # the reference acks on the serving set with the same exposure)
        self.commit_copies.setdefault(
            (chunk.encode(), meta.commit_ver), set()).add(
            (node.target_id, node.disk_epoch))
        prev = node.max_commit_seen.get(chunk.encode(), 0)
        if meta.commit_ver < prev:
            self.violations.append(
                f"I3: t{node.target_id} {chunk} commit_ver regressed "
                f"{prev} -> {meta.commit_ver}")
        node.max_commit_seen[chunk.encode()] = max(prev, meta.commit_ver)

    # ---- run + invariants ----

    def run(self, max_steps: int = 2000) -> list[str]:
        try:
            steps = 0
            while steps < max_steps:
                steps += 1
                # stop crashing once writes are done so the system can settle
                if len(self.done) >= self.writes_total:
                    self.crash_budget = 0
                    self.disk_fail_budget = 0
                if not self.step():
                    break
                if self._quiescent():
                    break
            # max_steps hit is fine — the deterministic drain finishes the run
            self._drain()
            self.check_invariants()
            return self.violations
        finally:
            for n in self.nodes.values():
                n.engine.close()
            self.tmp.cleanup()

    def _quiescent(self) -> bool:
        return (len(self.done) >= self.writes_total
                and not self.pending
                and not self.resync_inflight
                and all(n.alive and n.disk_ok for n in self.nodes.values())
                and not self.chain.syncing()
                and self.crash_budget == 0
                and len(self.chain.serving()) == len(self.nodes))

    def _operator_rescue(self) -> None:
        """Admin escape hatch the drain may use: a LASTSRV whose disk died
        holds the only authority and blocks everyone (it can't be replaced
        while LASTSRV, others can't resync without a serving source).  The
        operator runs the REAL rotate-lastsrv op (mgmtd.service.
        rotate_last_srv) — acknowledged loss of the dead copy's
        unreplicated versions (authority_lost horizon)."""
        from t3fs_torch.mgmtd.service import rotate_last_srv
        lastsrv = [t for t in self.chain.targets
                   if t.public_state == PublicTargetState.LASTSRV]
        if len(lastsrv) != 1 or self.chain.serving():
            return
        dead = self.node_of_target(lastsrv[0].target_id)
        if dead.disk_ok:
            return                     # it can still come back by itself
        # rotate_last_srv expects the lastsrv at the head of the order
        ordered = ([t for t in self.chain.targets
                    if t.target_id == dead.target_id]
                   + [t for t in self.chain.targets
                      if t.target_id != dead.target_id])
        rotated = rotate_last_srv(ordered)
        if rotated is ordered:
            return                     # helper refused (chain too short)
        for ck, cv in dead.max_commit_seen.items():
            self.authority_lost[ck] = max(self.authority_lost.get(ck, -1), cv)
        self.chain = ChainInfo(1, self.chain.chain_ver + 1, rotated)

    def _drain(self) -> None:
        """Force the system to settle: restart everyone, run mgmtd +
        resync + remaining writes to completion deterministically."""
        for _ in range(4000):
            # ops that never managed to apply anywhere despite many
            # chances are client failures (version holes after authority
            # loss can be permanently unappliable under the sim's fixed
            # numbering) — abandon them so the drain can settle the rest
            for op in list(self.pending):
                if not op.applied_somewhere and op.failed_attempts > 100:
                    self.pending.remove(op)
                    self.done.append(op)
            if self._quiescent():
                return
            self._operator_rescue()
            # one round of every recovery mechanism per iteration — a write
            # step may be a no-op while it waits for a routing change, so
            # membership/resync must advance in the same pass
            self._do_mgmtd_tick(None)
            for n in self.nodes.values():
                if not n.disk_ok and self._replace_allowed(n):
                    self._do_disk_replace(n)
                if not n.alive:
                    self._do_restart(n)
            self._do_mgmtd_tick(None)
            for op in self._head_serialized():
                self._do_write_step(op)
            if self.resync_inflight:
                self._do_resync_step(next(iter(self.resync_inflight)))
            else:
                acts: list = []
                self._maybe_enable_resync(acts)
                if acts:
                    self._do_resync_start(acts[0][1])
        self.violations.append("drain did not converge")

    def check_invariants(self) -> None:
        serving = [self.node_of_target(t) for t in self.serving_targets()]
        if not serving:
            self.violations.append("no serving replicas after drain")
            return
        for chunk in self.chunks:
            states = []
            for n in serving:
                meta = n.engine.get_meta(chunk)
                if meta is None:
                    states.append((n.target_id, None, None, None))
                else:
                    states.append((n.target_id, meta.commit_ver,
                                   meta.checksum, n.engine.read(chunk)))
            ref = states[0]
            for s in states[1:]:
                if s[1:] != ref[1:]:
                    self.violations.append(
                        f"I1: divergence on {chunk}: "
                        f"t{ref[0]}=(v{ref[1]},{ref[2]}) vs "
                        f"t{s[0]}=(v{s[1]},{s[2]})")
            # I2: last acked write per chunk is reflected
            acked = [op for op in self.done
                     if op.acked and op.chunk.encode() == chunk.encode()]
            if acked:
                last = max(acked, key=lambda o: o.ver)
                want = self.expected[chunk.encode()][last.ver]
                copies = self.commit_copies.get(
                    (chunk.encode(), last.ver), set())
                all_copies_burned = (
                    self.authority_lost.get(chunk.encode(), -1) >= last.ver
                    or (bool(copies) and all(
                        self.node_of_target(tid).disk_epoch > epoch
                        for tid, epoch in copies)))
                for tid, cver, _crc, data in states:
                    if cver is None or cver < last.ver:
                        if all_copies_burned:
                            continue  # every committed copy physically died
                        self.violations.append(
                            f"I2: t{tid} {chunk} lost acked write v{last.ver} "
                            f"(at v{cver})")
                    elif cver == last.ver and data != want:
                        self.violations.append(
                            f"I2: t{tid} {chunk} content mismatch at "
                            f"v{last.ver}")


def run_schedules(num: int = 50, *, seed0: int = 0, **kw) -> dict:
    """Run many seeded schedules; returns {seed: violations} for failures."""
    failures = {}
    for i in range(num):
        seed = seed0 + i
        sim = CraqSim(seed, **kw)
        v = sim.run()
        if v:
            failures[seed] = v
    return failures
