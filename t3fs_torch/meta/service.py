"""Meta RPC service + server wrapper (GC + session prune workers).

Reference analogs: meta/service/MetaOperator.{h,cc} (21 ops, MetaOperator.h:
47-96), components/GcManager (async chunk reclamation, GcManager.h:57-118),
components/SessionManager (prune dead-client sessions, SessionManager.h:44-83),
FileHelper (length via storage queryLastChunk).

The port of t3fs/meta/service.py.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.meta import acl
from t3fs_torch.meta.acl import UserInfo
from t3fs_torch.meta.events import MetaEventType
from t3fs_torch.meta.schema import DirEntry, FileSession, Inode, InodeType
from t3fs_torch.meta.store import ChainAllocator, MetaStore
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.net.wire import OkRsp
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.config import ConfigBase as _ConfigBase, citem as _citem
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.meta")


# --- wire types (fbs/meta/Service.h analog, trimmed to the core 16 ops) ---

@serde_struct
@dataclass
class PathReq:
    path: str = ""
    follow: bool = True
    recursive: bool = False
    perm: int = 0o644
    chunk_size: int = 0
    stripe: int = 0
    client_id: str = ""
    request_id: str = ""      # idempotency key for mutations (Idempotent.h)
    write: bool = False
    target: str = ""          # symlink target / rename dst / hardlink new path
    unlock: bool = False      # lock_directory
    # append-only (serde positional wire compat): new fields go LAST
    flags: int = 0            # rename: renameat2 NOREPLACE=1 / EXCHANGE=2
    user: UserInfo | None = None   # caller identity (None = trusted)
    rdwr: bool = False        # open: O_RDWR (needs R in addition to W)


@serde_struct
@dataclass
class LockDirReq:
    """LockDirectory by nodeid (fbs/meta/Service.h LockDirectoryReq)."""
    inode_id: int = 0
    client_id: str = ""
    action: str = "try_lock"  # try_lock | preempt_lock | unlock | clear


@serde_struct
@dataclass
class InodeReq:
    inode_id: int = 0
    session_id: str = ""
    length: int = -1          # -1: unknown (server settles via storage)
    position: int = 0
    user: UserInfo | None = None   # caller identity (None = trusted)


@serde_struct
@dataclass
class InodeRsp:
    inode: Inode | None = None
    session_id: str = ""


@serde_struct
@dataclass
class ReaddirRsp:
    entries: list[DirEntry] = field(default_factory=list)


@serde_struct
@dataclass
class StatFsRsp:
    capacity: int = 0
    used: int = 0
    free: int = 0


@serde_struct
@dataclass
class EntryReq:
    """Entry-level op addressing (FUSE lowlevel surface): parent nodeid +
    name, optional destination pair for rename."""
    parent: int = 0
    name: str = ""
    dparent: int = 0
    dname: str = ""
    target: str = ""          # symlink target
    perm: int = 0o644
    chunk_size: int = 0
    stripe: int = 0
    recursive: bool = False
    write: bool = False
    inode_id: int = 0
    client_id: str = ""
    request_id: str = ""
    limit: int = 0
    must_dir: int = -1        # unlink_at: -1 any, 0 must be file, 1 must be dir
    # append-only (serde positional wire compat): new fields go LAST
    flags: int = 0            # rename: renameat2 NOREPLACE=1 / EXCHANGE=2
    user: UserInfo | None = None   # caller identity (None = trusted)
    rdwr: bool = False        # open: O_RDWR (needs R in addition to W)


@serde_struct
@dataclass
class PruneSessionReq:
    client_id: str = ""
    session_ids: list[str] = field(default_factory=list)
    user: UserInfo | None = None   # caller identity (None = trusted)


@serde_struct
@dataclass
class SetAttrReq:
    """Inode-addressed setattr; -1 / NaN-free sentinel = unchanged."""
    inode_id: int = 0
    perm: int = -1
    uid: int = -1
    gid: int = -1
    atime: float = -1.0
    mtime: float = -1.0
    user: UserInfo | None = None   # caller identity (None = trusted)


@serde_struct
@dataclass
class BatchStatReq:
    paths: list[str] = field(default_factory=list)
    inode_ids: list[int] = field(default_factory=list)
    follow: bool = True
    user: UserInfo | None = None   # caller identity (None = trusted)


@serde_struct
@dataclass
class BatchStatRsp:
    inodes: list[Inode | None] = field(default_factory=list)


@serde_struct
@dataclass
class ReaddirPlusRsp:
    """One-RPC directory listing from one snapshot: the dir's inode,
    the entries as PARALLEL PRIMITIVE LISTS (compiled scalar fast
    paths — a struct decode per dirent was 40% of the listing cost),
    and each entry's inode as a RAW serde blob (b"" = raced away; the
    KV already stores the wire encoding, so the server passes it
    through and only the client decodes — the reference's
    fbs-serialized-inode pass-through shape)."""
    dir: Inode | None = None
    names: list[str] = field(default_factory=list)
    ids: list[int] = field(default_factory=list)
    types: list[int] = field(default_factory=list)
    inode_blobs: list[bytes] = field(default_factory=list)


@service("Meta")
class MetaService:
    def __init__(self, store: MetaStore, storage_client=None,
                 authenticator=None):
        self.store = store
        self.sc = storage_client   # FileHelper / GC path (may be None in tests)
        # optional async (claimed UserInfo) -> verified UserInfo hook; when
        # set, the registry's record (not the claim) is what gets enforced
        self.authenticator = authenticator

    async def _identity(self, req) -> UserInfo | None:
        """Caller identity for permission checks.  Without an
        authenticator, None (no user on the request) = trusted caller,
        enforcement off — matching deployments that run without
        authentication, like an un-exported local mount.  With an
        authenticator configured, EVERY request must carry an identity
        and it must verify (token check against the user registry,
        reference AuthReq flow) — omitting the field is a refusal, not a
        bypass, and the VERIFIED record is returned so a forged uid in
        the claim cannot escalate."""
        user = getattr(req, "user", None)
        if self.authenticator is None:
            return user
        if user is None:
            raise make_error(StatusCode.META_NO_PERMISSION,
                             "identity required (authenticated deployment)")
        return await self.authenticator(user)

    # each handler returns (rsp, b"")

    @staticmethod
    def _bind_conn(conn, client_id: str) -> None:
        """First-use identity binding: remember the first client_id a
        connection presents so ops acting on OTHER clients' state
        (prune_session) can refuse cross-client requests.  Not full
        authentication — it stops accidental/connection-reuse eviction,
        the hazard the reference's authenticated UserInfo prevents."""
        if conn is not None and client_id \
                and getattr(conn, "client_id", None) is None:
            conn.client_id = client_id

    @rpc_method
    async def stat(self, req: PathReq, payload, conn):
        return InodeRsp(inode=await self.store.stat(
            req.path, req.follow, user=await self._identity(req))), b""

    @rpc_method
    async def stat_inode(self, req: InodeReq, payload, conn):
        return InodeRsp(inode=await self.store.stat_inode(req.inode_id)), b""

    @rpc_method
    async def create(self, req: PathReq, payload, conn):
        # a write session only when the create is an open-for-write
        # (O_CREAT|O_WRONLY); a bare create (mknod-style) must not pin GC
        self._bind_conn(conn, req.client_id)
        inode, session = await self.store.create(
            req.path, req.perm, req.chunk_size, req.stripe, req.client_id,
            request_id=req.request_id, want_session=req.write,
            user=await self._identity(req))
        return InodeRsp(inode=inode, session_id=session), b""

    @rpc_method
    async def open(self, req: PathReq, payload, conn):
        self._bind_conn(conn, req.client_id)
        inode, session = await self.store.open_file(
            req.path, req.write, req.client_id,
            user=await self._identity(req), rdwr=req.rdwr)
        return InodeRsp(inode=inode, session_id=session), b""

    @rpc_method
    async def close(self, req: InodeReq, payload, conn):
        length = req.length if req.length >= 0 else None
        if length is None and self.sc is not None:
            inode = await self.store.stat_inode(req.inode_id)
            if inode.layout is not None:
                length = await self.sc.query_last_chunk(inode.layout,
                                                        req.inode_id)
        inode = await self.store.close_file(req.inode_id, req.session_id, length)
        return InodeRsp(inode=inode), b""

    @rpc_method
    async def sync(self, req: InodeReq, payload, conn):
        """fsync: settle precise length via storage (FileHelper analog)."""
        inode = await self.store.stat_inode(req.inode_id)
        if self.sc is not None and inode.layout is not None:
            length = await self.sc.query_last_chunk(inode.layout, req.inode_id)
            inode = await self.store.close_file(req.inode_id, "", length)
        return InodeRsp(inode=inode), b""

    @rpc_method
    async def report_write_position(self, req: InodeReq, payload, conn):
        await self.store.report_write_position(req.inode_id, req.position)
        return InodeRsp(), b""

    @rpc_method
    async def mkdirs(self, req: PathReq, payload, conn):
        return InodeRsp(inode=await self.store.mkdirs(
            req.path, req.perm, req.recursive, client_id=req.client_id,
            request_id=req.request_id,
            user=await self._identity(req))), b""

    @rpc_method
    async def readdir(self, req: PathReq, payload, conn):
        return ReaddirRsp(entries=await self.store.readdir(
            req.path, user=await self._identity(req))), b""

    @rpc_method
    async def remove(self, req: PathReq, payload, conn):
        await self.store.remove(req.path, req.recursive,
                                client_id=req.client_id,
                                request_id=req.request_id,
                                user=await self._identity(req))
        return InodeRsp(), b""

    @rpc_method
    async def rename(self, req: PathReq, payload, conn):
        if req.flags:
            # a flagged request must NEVER run as a plain destructive
            # rename — clients route flags to rename2, so this is a
            # misrouted/mixed-version call: refuse it
            raise make_error(StatusCode.INVALID_ARG,
                             "flagged rename must use rename2")
        await self.store.rename(req.path, req.target,
                                client_id=req.client_id,
                                request_id=req.request_id,
                                user=await self._identity(req))
        return InodeRsp(), b""

    @rpc_method
    async def rename2(self, req: PathReq, payload, conn):
        """Flagged rename lives under its OWN method so a mixed-version
        cluster fails with RPC_METHOD_NOT_FOUND instead of an old server
        silently dropping the trailing flags field and running a plain
        (destructive) rename."""
        await self.store.rename(req.path, req.target,
                                client_id=req.client_id,
                                request_id=req.request_id,
                                flags=req.flags,
                                user=await self._identity(req))
        return InodeRsp(), b""

    @rpc_method
    async def symlink(self, req: PathReq, payload, conn):
        return InodeRsp(inode=await self.store.symlink(
            req.path, req.target, client_id=req.client_id,
            request_id=req.request_id,
            user=await self._identity(req))), b""

    @rpc_method
    async def hardlink(self, req: PathReq, payload, conn):
        return InodeRsp(inode=await self.store.hardlink(
            req.path, req.target, client_id=req.client_id,
            request_id=req.request_id,
            user=await self._identity(req))), b""

    @rpc_method
    async def set_attr(self, req: PathReq, payload, conn):
        return InodeRsp(inode=await self.store.set_attr(
            req.path, perm=req.perm,
            user=await self._identity(req))), b""

    @rpc_method
    async def set_attr_inode(self, req: SetAttrReq, payload, conn):
        """chmod/chown/utimens by nodeid (FUSE lowlevel setattr)."""
        inode = await self.store.set_attr_inode(
            req.inode_id,
            perm=None if req.perm < 0 else req.perm,
            uid=None if req.uid < 0 else req.uid,
            gid=None if req.gid < 0 else req.gid,
            atime=None if req.atime < 0 else req.atime,
            mtime=None if req.mtime < 0 else req.mtime,
            user=await self._identity(req))
        return InodeRsp(inode=inode), b""

    @rpc_method
    async def truncate(self, req: InodeReq, payload, conn):
        """Truncate file data (chunks) + settle meta length."""
        inode = await self.store.stat_inode(req.inode_id)
        user = await self._identity(req)
        if user is not None:
            # truncate(2) needs W on the file
            acl.check(inode, user, acl.W, str(req.inode_id))
        if self.sc is not None and inode.layout is not None:
            await self.sc.truncate_file(inode.layout, req.inode_id,
                                        max(0, req.length))
        inode = await self.store.set_length(req.inode_id, max(0, req.length))
        # user-driven truncate only; set_length from length reconciliation
        # deliberately does not event (it is repair, not mutation)
        self.store._emit(MetaEventType.TRUNCATE, inode_id=req.inode_id,
                         length=max(0, req.length))
        return InodeRsp(inode=inode), b""

    @rpc_method
    async def get_real_path(self, req: InodeReq, payload, conn):
        path = await self.store.get_real_path(req.inode_id)
        return PathReq(path=path), b""

    @rpc_method
    async def lookup(self, req: EntryReq, payload, conn):
        """FUSE lookup: (parent nodeid, name) -> inode (FuseOps.cc:644)."""
        return InodeRsp(inode=await self.store.lookup(
            req.parent, req.name, user=await self._identity(req))), b""

    @rpc_method
    async def readdir_inode(self, req: EntryReq, payload, conn):
        return ReaddirRsp(entries=await self.store.readdir_inode(
            req.inode_id, req.limit,
            user=await self._identity(req))), b""

    @rpc_method
    async def readdir_plus(self, req: EntryReq, payload, conn):
        """Entries + attrs + the dir inode in one round trip (the FUSE
        OPENDIR/READDIRPLUS hot path; FuseOps.cc readdirplus)."""
        dir_inode, entries, inode_blobs = \
            await self.store.readdir_plus_raw(
                req.inode_id, req.limit, user=await self._identity(req))
        return ReaddirPlusRsp(dir=dir_inode,
                              names=[e.name for e in entries],
                              ids=[e.inode_id for e in entries],
                              types=[int(e.itype) for e in entries],
                              inode_blobs=inode_blobs), b""

    @rpc_method
    async def create_at(self, req: EntryReq, payload, conn):
        self._bind_conn(conn, req.client_id)
        inode, session = await self.store.create_at(
            req.parent, req.name, req.perm, req.chunk_size, req.stripe,
            req.client_id, request_id=req.request_id,
            want_session=req.write, user=await self._identity(req))
        return InodeRsp(inode=inode, session_id=session), b""

    @rpc_method
    async def mkdir_at(self, req: EntryReq, payload, conn):
        return InodeRsp(inode=await self.store.mkdir_at(
            req.parent, req.name, req.perm, client_id=req.client_id,
            request_id=req.request_id,
            user=await self._identity(req))), b""

    @rpc_method
    async def symlink_at(self, req: EntryReq, payload, conn):
        return InodeRsp(inode=await self.store.symlink_at(
            req.parent, req.name, req.target, client_id=req.client_id,
            request_id=req.request_id,
            user=await self._identity(req))), b""

    @rpc_method
    async def unlink_at(self, req: EntryReq, payload, conn):
        await self.store.unlink_at(
            req.parent, req.name, req.recursive, client_id=req.client_id,
            request_id=req.request_id,
            must_dir=None if req.must_dir < 0 else bool(req.must_dir),
            user=await self._identity(req))
        return InodeRsp(), b""

    @rpc_method
    async def rename_at(self, req: EntryReq, payload, conn):
        if req.flags:
            raise make_error(StatusCode.INVALID_ARG,
                             "flagged rename must use rename2_at")
        await self.store.rename_at(
            req.parent, req.name, req.dparent, req.dname,
            client_id=req.client_id, request_id=req.request_id,
            user=await self._identity(req))
        return InodeRsp(), b""

    @rpc_method
    async def rename2_at(self, req: EntryReq, payload, conn):
        """Entry-level flagged rename; own method name for the same
        mixed-version reason as rename2."""
        await self.store.rename_at(
            req.parent, req.name, req.dparent, req.dname,
            client_id=req.client_id, request_id=req.request_id,
            flags=req.flags, user=await self._identity(req))
        return InodeRsp(), b""

    @rpc_method
    async def link_at(self, req: EntryReq, payload, conn):
        """Entry-level hardlink (FUSE LINK): inode_id -> (parent, name)."""
        inode = await self.store.link_at(
            req.inode_id, req.parent, req.name,
            client_id=req.client_id, request_id=req.request_id,
            user=await self._identity(req))
        return InodeRsp(inode=inode), b""

    @rpc_method
    async def open_inode(self, req: EntryReq, payload, conn):
        self._bind_conn(conn, req.client_id)
        inode, session = await self.store.open_inode(
            req.inode_id, req.write, req.client_id,
            user=await self._identity(req), rdwr=req.rdwr)
        return InodeRsp(inode=inode, session_id=session), b""

    @rpc_method
    async def lock_directory(self, req: PathReq, payload, conn):
        """lockDirectory (fbs/meta/Service.h:718-741): pin a directory
        against entry mutations by other clients."""
        return InodeRsp(inode=await self.store.lock_directory(
            req.path, req.client_id, unlock=req.unlock)), b""

    @rpc_method
    async def lock_directory_inode(self, req: LockDirReq, payload, conn):
        """LockDirectory by nodeid with the reference's four actions
        (LockDirectory.cc:32-56) — the FUSE t3fs.lock xattr surface."""
        return InodeRsp(inode=await self.store.lock_directory_inode(
            req.inode_id, req.client_id, req.action)), b""

    @rpc_method
    async def batch_stat(self, req: BatchStatReq, payload, conn):
        if req.inode_ids:
            inodes = await self.store.batch_stat_inodes(req.inode_ids)
        else:
            inodes = await self.store.batch_stat(
                req.paths, req.follow, user=await self._identity(req))
        return BatchStatRsp(inodes=inodes), b""

    async def reconcile_lengths(self, inode_ids: list[int]) -> int:
        """Settle precise lengths for files whose writer died without close.

        A crashed writer leaves the inode at its last 5-second
        report_write_position hint; the reference's Distributor periodically
        recomputes the true length from storage queryLastChunk
        (docs/design_notes.md:91-95, meta/components/FileHelper.h).  Runs
        whenever session pruning evicts dead-writer sessions."""
        if self.sc is None:
            return 0
        fixed = 0
        for inode_id in set(inode_ids):
            try:
                inode = await self.store.stat_inode(inode_id)
                if inode.itype != InodeType.FILE or inode.layout is None:
                    continue
                # skip while other writers hold live sessions — their close
                # will settle the length with fresher information
                if await self.store.sessions_of(inode_id):
                    continue
                length = await self.sc.query_last_chunk(inode.layout, inode_id)
                if length != inode.length:
                    await self.store.set_length(inode_id, length)
                    fixed += 1
            except StatusError as e:
                log.warning("length reconcile of inode %d failed: %s",
                            inode_id, e)
        return fixed

    @rpc_method
    async def prune_session(self, req: PruneSessionReq, payload, conn):
        """Client-initiated prune of its OWN write sessions (reference
        PruneSession, fbs/meta/Service.h:734): an unmounting FUSE daemon
        releases sessions eagerly instead of waiting for the dead-client
        reaper.  `session_ids` limits the prune; otherwise every session of
        `client_id` goes.  Lengths reconcile like any reaped writer's.

        The prunable set derives from the CONNECTION's bound client id, not
        the request field alone: a connection is bound to the first
        client_id it presents (any session-creating op binds it), so a
        REUSED connection cannot evict another live client's sessions by
        naming it.  A fresh connection is still trusted for its first
        claim — full protection needs the authenticated deployment, where
        _identity refuses unidentified callers outright."""
        if not req.client_id:
            raise make_error(StatusCode.INVALID_ARG, "client_id required")
        await self._identity(req)   # authenticated deployments: verify
        bound = getattr(conn, "client_id", None) if conn is not None else None
        if bound is not None and bound != req.client_id:
            raise make_error(
                StatusCode.META_NO_PERMISSION,
                f"connection bound to client {bound!r} cannot prune "
                f"sessions of {req.client_id!r}")
        self._bind_conn(conn, req.client_id)
        sessions = await self.store.scan_sessions()
        mine = [s for s in sessions if s.client_id == req.client_id
                and (not req.session_ids or s.session_id in req.session_ids)]
        pruned = await self.store.clear_sessions(mine)
        await self.reconcile_lengths(pruned)
        return OkRsp(), b""

    @rpc_method
    async def list_inodes(self, req: EntryReq, payload, conn):
        """Raw inode-table scan (admin DumpInodes analog): returns inodes
        starting AFTER inode_id, up to limit — orphan auditing needs the raw
        table, not a tree walk."""
        inodes = await self.store.list_inodes(req.inode_id, req.limit or 1000)
        return BatchStatRsp(inodes=inodes), b""

    @rpc_method
    async def list_dirents(self, req: EntryReq, payload, conn):
        """Raw dirent-table scan (admin DumpDirEntries analog)."""
        return ReaddirRsp(entries=await self.store.list_dirents(
            req.inode_id, req.name, req.limit or 1000)), b""

    @rpc_method
    async def statfs(self, req, payload, conn):
        # aggregated from storage in a later round; placeholder totals
        return StatFsRsp(), b""


@dataclass
class MetaConfig(_ConfigBase):
    """Hot meta-service knobs (GC loop reads them live each iteration)."""
    gc_period_s: float = _citem(0.2, validator=lambda v: v > 0)
    session_ttl_s: float = _citem(3600.0, validator=lambda v: v > 0)
    # sessions of clients absent from mgmtd's client-session registry are
    # pruned after this grace (must exceed the client's first-extend delay)
    dead_client_grace_s: float = _citem(120.0, validator=lambda v: v > 0)


class MetaServer:
    """MetaService + background GC of removed files' chunks."""

    def __init__(self, store: MetaStore, storage_client,
                 gc_period_s: float = 0.2, session_ttl_s: float = 3600.0,
                 node_id: int = 0, admin_token: str = "",
                 meta_servers_provider=None, live_clients_provider=None):
        from t3fs_torch.meta.distributor import Distributor

        self.store = store
        self.sc = storage_client
        self.service = MetaService(store, storage_client)
        # rendezvous-hash duty sharding across meta servers (Distributor.h:29)
        self.distributor = Distributor(node_id, meta_servers_provider)
        # async () -> set[str] | None: live client ids from mgmtd's
        # client-session registry; None = tracking unavailable (TTL-only)
        self.live_clients_provider = live_clients_provider
        self.cfg = MetaConfig(gc_period_s=gc_period_s, session_ttl_s=session_ttl_s)
        from t3fs_torch.core.service import AppInfo, CoreService
        self.core = CoreService(AppInfo(node_id, "meta"),
                                config=self.cfg, kv=store.kv,
                                admin_token=admin_token)
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()
        # client_id -> first time it was observed absent from mgmtd's
        # registry while still holding sessions; deadness requires a FULL
        # grace period of absence, not one missing observation
        self._client_missing_since: dict[str, float] = {}
        self.gc_count = 0

    @property
    def gc_period_s(self) -> float:
        return self.cfg.gc_period_s

    @property
    def session_ttl_s(self) -> float:
        return self.cfg.session_ttl_s

    @property
    def services(self):
        return [self.service, self.core]

    async def start(self) -> None:
        self._task = asyncio.create_task(self._gc_loop(), name="meta-gc")

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "meta gc loop")

    async def _gc_loop(self) -> None:
        log.info("meta gc loop started (period %.2fs)", self.gc_period_s)
        last_prune = 0.0
        while not self._stopped.is_set():
            await asyncio.sleep(self.gc_period_s)
            try:
                now = time.time()
                prune_every = min(max(1.0, self.session_ttl_s / 10),
                                  max(1.0, self.cfg.dead_client_grace_s / 4))
                if now - last_prune > prune_every:
                    # duty-sharded across meta servers: only the rendezvous
                    # owner of the "sessions"/"idem" duties prunes them
                    if self.distributor.is_mine("prune-sessions"):
                        pruned = await self._prune_sessions_once(now)
                        await self.reconcile_lengths(pruned)
                    if self.distributor.is_mine("prune-idem"):
                        await self.store.prune_idem_records(
                            max(600.0, self.session_ttl_s))
                    last_prune = now
                await self.gc_once()
            except Exception:
                log.exception("meta gc failed")

    async def _prune_sessions_once(self, now: float) -> list[int]:
        """One prune tick: a single session scan feeds both the TTL pruner
        and the dead-client pruner (SessionManager.h:44-83 x
        MgmtdClientSessionsChecker).  A client is dead only after being
        absent from mgmtd's registry for dead_client_grace_s of CONTINUOUS
        observation — a single missing snapshot (mgmtd failover, transient
        client<->mgmtd blip) must not reap a healthy mount's sessions."""
        sessions = await self.store.scan_sessions()
        if not sessions:
            self._client_missing_since.clear()
            return []
        to_prune = {(s.inode_id, s.session_id): s for s in sessions
                    if s.created_at < now - self.session_ttl_s}
        if self.live_clients_provider is not None:
            live = await self.live_clients_provider()
            if live is not None:
                holders = {s.client_id for s in sessions if s.client_id}
                for c in list(self._client_missing_since):
                    if c in live or c not in holders:
                        del self._client_missing_since[c]
                for c in holders - live:
                    self._client_missing_since.setdefault(c, now)
                dead = {c for c, t0 in self._client_missing_since.items()
                        if now - t0 >= self.cfg.dead_client_grace_s}
                for s in sessions:
                    if s.client_id in dead:
                        to_prune[(s.inode_id, s.session_id)] = s
        return await self.store.clear_sessions(list(to_prune.values()))

    async def reconcile_lengths(self, inode_ids: list[int]) -> int:
        return await self.service.reconcile_lengths(inode_ids)

    async def gc_once(self) -> int:
        """Reclaim chunks of removed files (GcManager.h:57-118 analog);
        each inode is GC'd by its rendezvous-hash owner so multiple meta
        servers don't double-remove the same chunks."""
        inodes = await self.store.gc_pop(
            owned=self.distributor.is_mine
            if self.distributor.servers_provider else None)
        for inode in inodes:
            if inode.layout is not None and self.sc is not None:
                try:
                    await self.sc.remove_file_chunks(inode.layout, inode.inode_id)
                except StatusError as e:
                    log.warning("gc of inode %d failed (requeue): %s",
                                inode.inode_id, e)
                    # push back for retry
                    from t3fs_torch.kv.engine import with_transaction
                    from t3fs_torch.meta.schema import gc_key
                    from t3fs_torch.utils import serde as _serde

                    async def requeue(txn, inode=inode):
                        txn.set(gc_key(inode.inode_id), _serde.dumps(inode))
                    await with_transaction(self.store.kv, requeue)
                    continue
            self.gc_count += 1
            self.store._emit(MetaEventType.GC, inode_id=inode.inode_id,
                             length=inode.length)
        return len(inodes)
