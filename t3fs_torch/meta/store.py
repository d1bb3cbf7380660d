"""MetaStore: filesystem operations as KV transactions.

Reference analogs: meta/store/ops/* (one Operation object per op driven by
the FDB retry loop, MetaStore.h:54-66), PathResolve.h:28-113 (iterative walk,
symlink depth limits), components/InodeIdAllocator.h (batched ids),
components/ChainAllocator.h:48-81 (chain selection for new files).

The port of t3fs/meta/store.py.
"""

from __future__ import annotations

import asyncio
import itertools
import random
import struct
import time
import uuid as uuidlib

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.kv.engine import KVEngine, Transaction, with_transaction
from t3fs_torch.kv.prefixes import KeyPrefix
from t3fs_torch.meta import acl
from t3fs_torch.meta.acl import UserInfo
from t3fs_torch.meta.events import MetaEventType as Ev
from t3fs_torch.meta.schema import (
    GC_PREFIX, IDEM_PREFIX, DirEntry, FileSession, IdemRecord, Inode,
    InodeType, ROOT_INODE_ID, gc_key, idem_key,
)
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

MAX_SYMLINK_DEPTH = 10
ID_BATCH = 1024


class InodeIdAllocator:
    """Batched monotonic inode ids from the KV (InodeIdAllocator.h:52)."""

    def __init__(self, kv: KVEngine):
        self.kv = kv
        self._next = 0
        self._limit = 0
        self._lock = asyncio.Lock()

    async def allocate(self) -> int:
        async with self._lock:
            if self._next >= self._limit:
                async def bump(txn: Transaction):
                    raw = await txn.get(KeyPrefix.ALLOCATOR.key(b"inode"))
                    cur = int(raw) if raw else ROOT_INODE_ID + 1
                    txn.set(KeyPrefix.ALLOCATOR.key(b"inode"),
                            str(cur + ID_BATCH).encode())
                    return cur
                self._next = await with_transaction(self.kv, bump)
                self._limit = self._next + ID_BATCH
            out = self._next
            self._next += 1
            return out


class ChainAllocator:
    """Round-robin + seeded-shuffle chain selection for new file layouts
    (ChainAllocator.h:48-81): stripe_size chains from the chain table."""

    def __init__(self, routing_provider, default_chunk_size: int = 512 * 1024,
                 default_stripe: int = 1):
        self.routing = routing_provider
        self.default_chunk_size = default_chunk_size
        self.default_stripe = default_stripe
        self._rr = itertools.count()

    def allocate_layout(self, chunk_size: int = 0, stripe: int = 0) -> FileLayout:
        routing = self.routing()
        table = routing.chain_tables.get(1)
        chain_ids = table.chain_ids if table else sorted(routing.chains)
        if not chain_ids:
            raise make_error(StatusCode.INTERNAL, "no chains available for layout")
        stripe = min(stripe or self.default_stripe, len(chain_ids))
        start = next(self._rr) % len(chain_ids)
        picked = [chain_ids[(start + i) % len(chain_ids)] for i in range(stripe)]
        return FileLayout(chunk_size=chunk_size or self.default_chunk_size,
                          stripe_size=stripe, chains=picked,
                          seed=random.getrandbits(16) if stripe > 1 else 0)


class MetaStore:
    def __init__(self, kv: KVEngine, chain_allocator: ChainAllocator,
                 event_log=None):
        self.kv = kv
        self.chains = chain_allocator
        self.ids = InodeIdAllocator(kv)
        self.events = event_log    # MetaEventLog | None (meta/events.py)
        self._root_ready = False
        self._root_lock = asyncio.Lock()

    def _emit(self, etype, **fields) -> None:
        """Post-commit event emission (src/meta/event/Event.h): callers emit
        only after the transaction driver returned success, so aborted ops
        never log.  Replays of idempotent ops may re-emit — events are
        observability, duplicates are harmless."""
        if self.events is not None:
            self.events.emit(etype, **fields)

    async def _ensure_root(self) -> None:
        """Bootstrap the root inode on a fresh store.  _root_ready flips only
        after a successful commit, so a transient commit failure leaves the
        bootstrap to be retried by the next op."""
        if self._root_ready:
            return
        async with self._root_lock:
            if self._root_ready:
                return

            async def fn(txn: Transaction) -> None:
                if await txn.get(Inode.key(ROOT_INODE_ID), snapshot=True) is None:
                    root = Inode(inode_id=ROOT_INODE_ID,
                                 itype=InodeType.DIRECTORY,
                                 perm=0o755, nlink=2).touch()
                    txn.set(Inode.key(ROOT_INODE_ID), serde.dumps(root))

            await with_transaction(self.kv, fn)
            self._root_ready = True

    async def _txn(self, fn):
        """All meta ops enter here: root bootstrap, then the retry driver."""
        await self._ensure_root()
        return await with_transaction(self.kv, fn)

    async def _txn_idem(self, fn, op: str, client_id: str, request_id: str):
        """Idempotent mutation driver (reference meta/store/Idempotent.h):
        with a (client_id, request_id) pair, the op's outcome is recorded in
        the SAME transaction that applies it — a replay (client retry after
        a lost response, possibly against another meta server on the same
        KV) returns the recorded result instead of double-applying or
        failing with a confusing META_EXISTS / META_NOT_FOUND."""
        if not request_id or not client_id:
            return await self._txn(fn)

        tuple_ops = ("create", "open")   # ops returning (inode, session_id)

        async def outer(txn: Transaction):
            key = idem_key(request_id, client_id)
            raw = await txn.get(key)
            if raw is not None:
                rec: IdemRecord = serde.loads(raw)
                return (rec.inode, rec.extra) if rec.op in tuple_ops \
                    else rec.inode
            result = await fn(txn)
            if isinstance(result, tuple):
                inode, extra = result[0], result[1]
            else:
                inode = result if isinstance(result, Inode) else None
                extra = ""
            txn.set(key, serde.dumps(IdemRecord(
                client_id=client_id, request_id=request_id,
                timestamp=time.time(), op=op, inode=inode,
                extra=extra or "")))
            return result
        # replay-safe (the idem record absorbs double-execution), so an
        # ambiguous commit outcome is retried instead of surfacing
        await self._ensure_root()
        return await with_transaction(self.kv, outer,
                                      retry_maybe_committed=True)

    @staticmethod
    def _check_dir_lock(inode: Inode, client_id: str, path: str) -> None:
        """Entry mutations under a locked directory are rejected unless the
        caller holds the lock (LockDirectory semantics)."""
        if inode.dir_lock and inode.dir_lock != client_id:
            raise make_error(
                StatusCode.META_DIR_LOCKED,
                f"{path}: directory locked by {inode.dir_lock!r}")

    async def _require_unlocked_dir(self, txn: Transaction, parent: int,
                                    client_id: str, path: str) -> Inode:
        inode = await self._require_inode(txn, parent)
        if inode.itype != InodeType.DIRECTORY:
            # entry-level callers (FUSE lowlevel) can pass any nodeid as
            # parent; a DirEntry under a FILE inode would orphan children
            raise make_error(StatusCode.META_NOT_DIR, path)
        self._check_dir_lock(inode, client_id, path)
        return inode

    # --- txn helpers ---

    @staticmethod
    async def _get_inode(txn: Transaction, inode_id: int) -> Inode | None:
        raw = await txn.get(Inode.key(inode_id))
        return serde.loads(raw) if raw else None

    @staticmethod
    async def _require_inode(txn: Transaction, inode_id: int) -> Inode:
        inode = await MetaStore._get_inode(txn, inode_id)
        if inode is None:
            raise make_error(StatusCode.META_NOT_FOUND, f"inode {inode_id}")
        return inode

    @staticmethod
    async def _get_dent(txn: Transaction, parent: int, name: str) -> DirEntry | None:
        raw = await txn.get(DirEntry.key(parent, name))
        return serde.loads(raw) if raw else None

    @staticmethod
    def _open_bits(write: bool, rdwr: bool) -> int:
        """open(2) accmode -> required permission bits."""
        if rdwr:
            return acl.R | acl.W
        return acl.W if write else acl.R

    async def _check_access(self, txn: Transaction, inode_or_id,
                            user: UserInfo | None, bits: int,
                            path: str = "") -> Inode | None:
        """Permission gate for one inode (reference: per-op
        inode.acl.checkPermission, src/meta/store/ops/SetAttr.h:76,99).
        user=None (trusted caller) skips the inode fetch entirely, so
        unauthenticated deployments pay nothing.  Returns the inode it
        checked (None when skipped)."""
        if user is None or acl.is_root(user):
            return None
        inode = inode_or_id if isinstance(inode_or_id, Inode) \
            else await self._require_inode(txn, inode_or_id)
        acl.check(inode, user, bits, path)
        return inode

    async def resolve(self, txn: Transaction, path: str,
                      follow_last: bool = True,
                      user: UserInfo | None = None
                      ) -> tuple[int, str, DirEntry | None]:
        """Path -> (parent_inode_id, last_name, existing dent-or-None).
        Iterative with symlink expansion limits (PathResolve.h:28-113).
        With a user, every directory searched needs X (POSIX traversal)."""
        depth = 0
        parts = [p for p in path.split("/") if p]
        parent = ROOT_INODE_ID
        i = 0
        while i < len(parts):
            name = parts[i]
            last = i == len(parts) - 1
            await self._check_access(txn, parent, user, acl.X,
                                     "/".join(parts[:i]) or "/")
            dent = await self._get_dent(txn, parent, name)
            if last and (dent is None or not follow_last
                         or dent.itype != InodeType.SYMLINK):
                return parent, name, dent
            if dent is None:
                raise make_error(StatusCode.META_NOT_FOUND,
                                 "/".join(parts[: i + 1]))
            if dent.itype == InodeType.SYMLINK:
                depth += 1
                if depth > MAX_SYMLINK_DEPTH:
                    raise make_error(StatusCode.META_TOO_MANY_SYMLINKS, path)
                inode = await self._require_inode(txn, dent.inode_id)
                target_parts = [p for p in inode.symlink_target.split("/") if p]
                if inode.symlink_target.startswith("/"):
                    parent = ROOT_INODE_ID
                parts = target_parts + parts[i + 1:]
                i = 0
                continue
            if not last and dent.itype != InodeType.DIRECTORY:
                raise make_error(StatusCode.META_NOT_DIR,
                                 "/".join(parts[: i + 1]))
            parent = dent.inode_id
            i += 1
        return ROOT_INODE_ID, "", None   # path was "/" or empty

    # --- ops (each returns a plain result; run via with_transaction) ---

    async def stat(self, path: str, follow: bool = True,
                   user: UserInfo | None = None) -> Inode:
        async def fn(txn: Transaction):
            if path.strip("/") == "":
                return await self._require_inode(txn, ROOT_INODE_ID)
            parent, name, dent = await self.resolve(txn, path,
                                                    follow_last=follow,
                                                    user=user)
            if dent is None:
                raise make_error(StatusCode.META_NOT_FOUND, path)
            return await self._require_inode(txn, dent.inode_id)
        return await self._txn(fn)

    async def stat_inode(self, inode_id: int) -> Inode:
        async def fn(txn: Transaction):
            return await self._require_inode(txn, inode_id)
        return await self._txn(fn)

    async def mkdirs(self, path: str, perm: int = 0o755,
                     recursive: bool = True, client_id: str = "",
                     request_id: str = "",
                     user: UserInfo | None = None) -> Inode:
        async def fn(txn: Transaction):
            parts = [p for p in path.split("/") if p]
            if not parts:
                raise make_error(StatusCode.META_EXISTS, "/")
            parent = ROOT_INODE_ID
            created: Inode | None = None
            lock_checked = False
            for i, name in enumerate(parts):
                if created is None:
                    # pre-existing dirs need X to traverse; the deepest
                    # one (where creation starts) additionally needs W
                    # below.  Dirs this txn just created are the user's.
                    await self._check_access(txn, parent, user, acl.X,
                                             "/".join(parts[:i]) or "/")
                dent = await self._get_dent(txn, parent, name)
                last = i == len(parts) - 1
                if dent is not None:
                    if last:
                        raise make_error(StatusCode.META_EXISTS, path)
                    if dent.itype != InodeType.DIRECTORY:
                        raise make_error(StatusCode.META_NOT_DIR, name)
                    parent = dent.inode_id
                    continue
                if not last and not recursive:
                    raise make_error(StatusCode.META_NOT_FOUND, name)
                if not lock_checked:
                    # only the first (pre-existing) parent can be locked;
                    # deeper parents are directories this txn just created
                    await self._require_unlocked_dir(txn, parent, client_id,
                                                     path)
                    await self._check_access(txn, parent, user, acl.W,
                                             "/".join(parts[:i]) or "/")
                    lock_checked = True
                inode_id = await self.ids.allocate()
                inode = Inode(inode_id=inode_id, itype=InodeType.DIRECTORY,
                              perm=perm, nlink=2, parent=parent,
                              uid=user.uid if user else 0,
                              gid=acl.primary_gid(user) if user else 0
                              ).touch()
                txn.set(Inode.key(inode_id), serde.dumps(inode))
                txn.set(DirEntry.key(parent, name), serde.dumps(
                    DirEntry(parent, name, inode_id, InodeType.DIRECTORY)))
                parent = inode_id
                created = inode
            return created
        created = await self._txn_idem(fn, "mkdirs", client_id, request_id)
        if created is not None:
            self._emit(Ev.MKDIR, inode_id=created.inode_id,
                       parent_id=created.parent, entry_name=path,
                       inode_type="dir", client_id=client_id)
        return created

    async def create(self, path: str, perm: int = 0o644, chunk_size: int = 0,
                     stripe: int = 0, session_client: str = "",
                     request_id: str = "",
                     want_session: bool = True,
                     user: UserInfo | None = None) -> tuple[Inode, str]:
        """Create a file (+ optional write session). Returns (inode, session_id).
        want_session=False creates without a write session (mknod-style) while
        session_client still keys idempotency."""
        layout = self.chains.allocate_layout(chunk_size, stripe)

        async def fn(txn: Transaction):
            parent, name, dent = await self.resolve(txn, path, user=user)
            if dent is not None:
                raise make_error(StatusCode.META_EXISTS, path)
            if not name:
                raise make_error(StatusCode.META_INVALID_PATH, path)
            await self._require_unlocked_dir(txn, parent, session_client, path)
            await self._check_access(txn, parent, user, acl.W, path)
            inode_id = await self.ids.allocate()
            inode = Inode(inode_id=inode_id, itype=InodeType.FILE, perm=perm,
                          layout=layout,
                          uid=user.uid if user else 0,
                          gid=acl.primary_gid(user) if user else 0).touch()
            txn.set(Inode.key(inode_id), serde.dumps(inode))
            txn.set(DirEntry.key(parent, name), serde.dumps(
                DirEntry(parent, name, inode_id, InodeType.FILE)))
            session_id = ""
            if session_client and want_session:
                session_id = str(uuidlib.uuid4())
                sess = FileSession(inode_id, session_id, session_client,
                                   time.time())
                txn.set(FileSession.key(inode_id, session_id), serde.dumps(sess))
            return inode, session_id
        inode, session_id = await self._txn_idem(
            fn, "create", session_client, request_id)
        self._emit(Ev.CREATE, inode_id=inode.inode_id, entry_name=path,
                   inode_type="file", client_id=session_client)
        return inode, session_id

    async def open_file(self, path: str, write: bool = False,
                        session_client: str = "",
                        user: UserInfo | None = None,
                        rdwr: bool = False) -> tuple[Inode, str]:
        async def fn(txn: Transaction):
            parent, name, dent = await self.resolve(txn, path, user=user)
            if dent is None:
                raise make_error(StatusCode.META_NOT_FOUND, path)
            inode = await self._require_inode(txn, dent.inode_id)
            if inode.itype == InodeType.DIRECTORY and write:
                raise make_error(StatusCode.META_IS_DIR, path)
            # open(2) access check: O_RDONLY needs R, O_WRONLY needs W,
            # O_RDWR needs BOTH (a 0o200 write-only file must not leak
            # its contents through an O_RDWR handle)
            await self._check_access(txn, inode, user,
                                     self._open_bits(write, rdwr), path)
            session_id = ""
            if write and session_client:
                session_id = str(uuidlib.uuid4())
                txn.set(FileSession.key(inode.inode_id, session_id),
                        serde.dumps(FileSession(inode.inode_id, session_id,
                                                session_client, time.time())))
            return inode, session_id
        inode, session_id = await self._txn(fn)
        if write:
            self._emit(Ev.OPEN_WRITE, inode_id=inode.inode_id,
                       entry_name=path, client_id=session_client)
        return inode, session_id

    async def close_file(self, inode_id: int, session_id: str = "",
                         length: int | None = None) -> Inode:
        """Close/sync: settle length (caller computes via storage
        query_last_chunk — FileOperation analog) and drop the session."""
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            if length is not None and inode.itype == InodeType.FILE:
                inode.length = length
                inode.touch()
                txn.set(Inode.key(inode_id), serde.dumps(inode))
            if session_id:
                txn.clear(FileSession.key(inode_id, session_id))
            return inode
        inode = await self._txn(fn)
        if session_id:   # read-only closes and fsyncs are not write closes
            self._emit(Ev.CLOSE_WRITE, inode_id=inode_id, length=inode.length)
        return inode

    async def report_write_position(self, inode_id: int, position: int) -> None:
        """Max-write-position hint, reported every few seconds by writers
        (docs/design_notes.md:91-95)."""
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            if position > inode.length_hint:
                inode.length_hint = position
                if position > inode.length:
                    inode.length = position
                txn.set(Inode.key(inode_id), serde.dumps(inode))
        await self._txn(fn)

    async def readdir(self, path: str, limit: int = 0,
                      user: UserInfo | None = None) -> list[DirEntry]:
        async def fn(txn: Transaction):
            if path.strip("/") == "":
                dir_id = ROOT_INODE_ID
            else:
                parent, name, dent = await self.resolve(txn, path, user=user)
                if dent is None:
                    raise make_error(StatusCode.META_NOT_FOUND, path)
                if dent.itype != InodeType.DIRECTORY:
                    raise make_error(StatusCode.META_NOT_DIR, path)
                dir_id = dent.inode_id
            await self._check_access(txn, dir_id, user, acl.R, path)
            pre = DirEntry.prefix(dir_id)
            rows = await txn.get_range(pre, pre + b"\xff", limit=limit)
            return [serde.loads(v) for _, v in rows]
        return await self._txn(fn)

    async def symlink(self, path: str, target: str,
                      client_id: str = "", request_id: str = "",
                      user: UserInfo | None = None) -> Inode:
        async def fn(txn: Transaction):
            parent, name, dent = await self.resolve(txn, path,
                                                    follow_last=False,
                                                    user=user)
            if dent is not None:
                raise make_error(StatusCode.META_EXISTS, path)
            await self._require_unlocked_dir(txn, parent, client_id, path)
            await self._check_access(txn, parent, user, acl.W, path)
            inode_id = await self.ids.allocate()
            inode = Inode(inode_id=inode_id, itype=InodeType.SYMLINK,
                          symlink_target=target,
                          uid=user.uid if user else 0,
                          gid=acl.primary_gid(user) if user else 0).touch()
            txn.set(Inode.key(inode_id), serde.dumps(inode))
            txn.set(DirEntry.key(parent, name), serde.dumps(
                DirEntry(parent, name, inode_id, InodeType.SYMLINK)))
            return inode
        inode = await self._txn_idem(fn, "symlink", client_id, request_id)
        self._emit(Ev.SYMLINK, inode_id=inode.inode_id, entry_name=path,
                   symlink_target=target, client_id=client_id)
        return inode

    async def lock_directory(self, path: str, owner: str,
                             unlock: bool = False) -> Inode:
        """Lock/unlock a directory against entry mutations by other clients
        (fbs/meta/Service.h lockDirectory).  Locking an already-locked dir
        by a different owner fails; unlock requires the owner (or force via
        the same RPC with the current owner string)."""
        async def fn(txn: Transaction):
            if path.strip("/") == "":
                inode = await self._require_inode(txn, ROOT_INODE_ID)
            else:
                _, _, dent = await self.resolve(txn, path)
                if dent is None:
                    raise make_error(StatusCode.META_NOT_FOUND, path)
                inode = await self._require_inode(txn, dent.inode_id)
            if inode.itype != InodeType.DIRECTORY:
                raise make_error(StatusCode.META_NOT_DIR, path)
            if self._apply_lock_action(inode, owner,
                                       "unlock" if unlock else "try_lock"):
                inode.touch()
                txn.set(Inode.key(inode.inode_id), serde.dumps(inode))
            return inode
        return await self._txn(fn)

    @staticmethod
    def _apply_lock_action(inode: Inode, owner: str, action: str) -> bool:
        """Shared LockDirectory action semantics
        (src/meta/store/ops/LockDirectory.cc:32-56): ``try_lock`` fails
        when held by another owner then locks, ``preempt_lock`` steals
        unconditionally, ``unlock`` requires the holder then clears,
        ``clear`` force-clears.  Returns True when the inode changed
        (caller persists it)."""
        if action in ("try_lock", "preempt_lock"):
            if action == "try_lock" and inode.dir_lock \
                    and inode.dir_lock != owner:
                raise make_error(StatusCode.META_DIR_LOCKED,
                                 f"locked by {inode.dir_lock!r}")
            if inode.dir_lock == owner:
                return False               # idempotent re-lock: no write
            inode.dir_lock = owner
            return True
        if action in ("unlock", "clear"):
            if action == "unlock":
                if not inode.dir_lock:
                    raise make_error(StatusCode.META_DIR_LOCKED,
                                     "not locked")
                if inode.dir_lock != owner:
                    raise make_error(StatusCode.META_DIR_LOCKED,
                                     f"locked by {inode.dir_lock!r}")
            if not inode.dir_lock:
                return False               # already clear: no write
            inode.dir_lock = ""
            return True
        raise make_error(StatusCode.INVALID_ARG,
                         f"bad lock action {action!r}")

    async def lock_directory_inode(self, inode_id: int, owner: str,
                                   action: str) -> Inode:
        """LockDirectory actions over a nodeid (the FUSE ``t3fs.lock``
        xattr surface; src/meta/store/ops/LockDirectory.cc:32-56):
        ``try_lock`` fails when held by another owner then locks,
        ``preempt_lock`` steals unconditionally, ``unlock`` requires the
        holder then clears, ``clear`` force-clears."""
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            if inode.itype != InodeType.DIRECTORY:
                raise make_error(StatusCode.META_NOT_DIR, str(inode_id))
            if self._apply_lock_action(inode, owner, action):
                inode.touch()
                txn.set(Inode.key(inode.inode_id), serde.dumps(inode))
            return inode
        return await self._txn(fn)

    # --- entry-level ops (FUSE lowlevel surface: (parent nodeid, name)) ---

    async def lookup(self, parent: int, name: str,
                     user: UserInfo | None = None) -> Inode:
        """FUSE lookup (FuseOps.cc:644): (parent inode, name) -> child inode."""
        async def fn(txn: Transaction):
            await self._check_access(txn, parent, user, acl.X, name)
            dent = await self._get_dent(txn, parent, name)
            if dent is None:
                raise make_error(StatusCode.META_NOT_FOUND,
                                 f"{parent}/{name}")
            return await self._require_inode(txn, dent.inode_id)
        return await self._txn(fn)

    async def readdir_inode(self, inode_id: int, limit: int = 0,
                            user: UserInfo | None = None) -> list[DirEntry]:
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            if inode.itype != InodeType.DIRECTORY:
                raise make_error(StatusCode.META_NOT_DIR, str(inode_id))
            await self._check_access(txn, inode, user, acl.R, str(inode_id))
            pre = DirEntry.prefix(inode_id)
            rows = await txn.get_range(pre, pre + b"\xff", limit=limit)
            return [serde.loads(v) for _, v in rows]
        return await self._txn(fn)

    async def readdir_plus_inode(
            self, inode_id: int, limit: int = 0,
            user: UserInfo | None = None
    ) -> tuple[Inode, list[DirEntry], list[Inode | None]]:
        """readdir + every entry's inode + the dir's own inode from ONE
        transaction (FuseOps.cc readdirplus role).  One snapshot means
        entries and attrs can't tear against each other, and a FUSE
        directory listing costs one meta RPC instead of three
        (readdir_inode + stat_inode at OPENDIR + batch_stat_inodes at
        the first READDIRPLUS page)."""
        dir_inode, entries, inode_blobs = \
            await self.readdir_plus_raw(inode_id, limit, user)
        return (dir_inode, entries,
                serde.loads_many(inode_blobs, Inode))

    async def readdir_plus_raw(
            self, inode_id: int, limit: int = 0,
            user: UserInfo | None = None
    ) -> tuple[Inode, list[DirEntry], list[bytes]]:
        """readdir_plus with the entry INODES passed through as RAW serde
        blobs (b"" = entry raced away): the KV already stores the wire
        encoding, so the server skips a decode+re-encode per inode
        (~25 tag reads each in pure Python) and the CLIENT decodes once
        — the same pass-through shape the reference uses for
        fbs-serialized inodes.  Dirents are decoded here (needed for the
        inode ids) and shipped as parallel primitive lists by the RPC
        layer."""
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            if inode.itype != InodeType.DIRECTORY:
                raise make_error(StatusCode.META_NOT_DIR, str(inode_id))
            await self._check_access(txn, inode, user, acl.R, str(inode_id))
            pre = DirEntry.prefix(inode_id)
            rows = await txn.get_range(pre, pre + b"\xff", limit=limit)
            entries = serde.loads_many([v for _, v in rows], DirEntry)
            raws = await txn.get_many(
                [Inode.key(e.inode_id) for e in entries])
            return inode, entries, [r if r else b"" for r in raws]
        return await self._txn(fn)

    async def create_at(self, parent: int, name: str, perm: int = 0o644,
                        chunk_size: int = 0, stripe: int = 0,
                        session_client: str = "", request_id: str = "",
                        want_session: bool = True,
                        user: UserInfo | None = None) -> tuple[Inode, str]:
        layout = self.chains.allocate_layout(chunk_size, stripe)

        async def fn(txn: Transaction):
            if await self._get_dent(txn, parent, name) is not None:
                raise make_error(StatusCode.META_EXISTS, name)
            await self._require_unlocked_dir(txn, parent, session_client, name)
            await self._check_access(txn, parent, user, acl.W | acl.X, name)
            inode_id = await self.ids.allocate()
            inode = Inode(inode_id=inode_id, itype=InodeType.FILE, perm=perm,
                          layout=layout,
                          uid=user.uid if user else 0,
                          gid=acl.primary_gid(user) if user else 0).touch()
            txn.set(Inode.key(inode_id), serde.dumps(inode))
            txn.set(DirEntry.key(parent, name), serde.dumps(
                DirEntry(parent, name, inode_id, InodeType.FILE)))
            session_id = ""
            if session_client and want_session:
                session_id = str(uuidlib.uuid4())
                txn.set(FileSession.key(inode_id, session_id), serde.dumps(
                    FileSession(inode_id, session_id, session_client,
                                time.time())))
            return inode, session_id
        inode, session_id = await self._txn_idem(
            fn, "create", session_client, request_id)
        self._emit(Ev.CREATE, inode_id=inode.inode_id, parent_id=parent,
                   entry_name=name, inode_type="file",
                   client_id=session_client)
        return inode, session_id

    async def mkdir_at(self, parent: int, name: str, perm: int = 0o755,
                       client_id: str = "", request_id: str = "",
                       user: UserInfo | None = None) -> Inode:
        async def fn(txn: Transaction):
            if await self._get_dent(txn, parent, name) is not None:
                raise make_error(StatusCode.META_EXISTS, name)
            await self._require_unlocked_dir(txn, parent, client_id, name)
            await self._check_access(txn, parent, user, acl.W | acl.X, name)
            inode_id = await self.ids.allocate()
            inode = Inode(inode_id=inode_id, itype=InodeType.DIRECTORY,
                          perm=perm, nlink=2, parent=parent,
                          uid=user.uid if user else 0,
                          gid=acl.primary_gid(user) if user else 0).touch()
            txn.set(Inode.key(inode_id), serde.dumps(inode))
            txn.set(DirEntry.key(parent, name), serde.dumps(
                DirEntry(parent, name, inode_id, InodeType.DIRECTORY)))
            return inode
        inode = await self._txn_idem(fn, "mkdirs", client_id, request_id)
        self._emit(Ev.MKDIR, inode_id=inode.inode_id, parent_id=parent,
                   entry_name=name, inode_type="dir", client_id=client_id)
        return inode

    async def symlink_at(self, parent: int, name: str, target: str,
                         client_id: str = "", request_id: str = "",
                         user: UserInfo | None = None) -> Inode:
        async def fn(txn: Transaction):
            if await self._get_dent(txn, parent, name) is not None:
                raise make_error(StatusCode.META_EXISTS, name)
            await self._require_unlocked_dir(txn, parent, client_id, name)
            await self._check_access(txn, parent, user, acl.W | acl.X, name)
            inode_id = await self.ids.allocate()
            inode = Inode(inode_id=inode_id, itype=InodeType.SYMLINK,
                          symlink_target=target,
                          uid=user.uid if user else 0,
                          gid=acl.primary_gid(user) if user else 0).touch()
            txn.set(Inode.key(inode_id), serde.dumps(inode))
            txn.set(DirEntry.key(parent, name), serde.dumps(
                DirEntry(parent, name, inode_id, InodeType.SYMLINK)))
            return inode
        inode = await self._txn_idem(fn, "symlink", client_id, request_id)
        self._emit(Ev.SYMLINK, inode_id=inode.inode_id, parent_id=parent,
                   entry_name=name, symlink_target=target,
                   client_id=client_id)
        return inode

    async def _check_unlink_perm(self, txn: Transaction, parent: int,
                                 dent: DirEntry, user: UserInfo | None,
                                 name: str) -> None:
        """unlink/rmdir/rename-source gate: W+X on the parent plus the
        sticky-bit restricted-deletion rule."""
        if user is None or acl.is_root(user):
            return
        pinode = await self._require_inode(txn, parent)
        acl.check(pinode, user, acl.W | acl.X, name)
        if pinode.perm & acl.S_ISVTX:
            entry = await self._require_inode(txn, dent.inode_id)
            acl.check_sticky(pinode, entry, user, name)

    async def _unlink_body(self, txn: Transaction, parent: int, name: str,
                           dent: DirEntry, recursive: bool, client_id: str,
                           must_dir: bool | None = None,
                           user: UserInfo | None = None) -> None:
        await self._require_unlocked_dir(txn, parent, client_id, name)
        await self._check_unlink_perm(txn, parent, dent, user, name)
        if must_dir is True and dent.itype != InodeType.DIRECTORY:
            raise make_error(StatusCode.META_NOT_DIR, name)   # rmdir(file)
        if must_dir is False and dent.itype == InodeType.DIRECTORY:
            raise make_error(StatusCode.META_IS_DIR, name)    # unlink(dir)
        if dent.itype == InodeType.DIRECTORY:
            await self._require_unlocked_dir(txn, dent.inode_id,
                                             client_id, name)
            pre = DirEntry.prefix(dent.inode_id)
            children = await txn.get_range(pre, pre + b"\xff")
            if children and not recursive:
                raise make_error(StatusCode.META_NOT_EMPTY, name)
            for _, raw in children:
                child: DirEntry = serde.loads(raw)
                await self._remove_tree(txn, child, client_id, user=user)
                txn.clear(DirEntry.key(child.parent, child.name))
        await self._unlink_entry(txn, dent)
        txn.clear(DirEntry.key(parent, name))

    async def unlink_at(self, parent: int, name: str, recursive: bool = False,
                        client_id: str = "", request_id: str = "",
                        must_dir: bool | None = None,
                        user: UserInfo | None = None) -> None:
        async def fn(txn: Transaction):
            dent = await self._get_dent(txn, parent, name)
            if dent is None:
                raise make_error(StatusCode.META_NOT_FOUND, name)
            await self._unlink_body(txn, parent, name, dent, recursive,
                                    client_id, must_dir, user=user)
        result = await self._txn_idem(fn, "remove", client_id, request_id)
        self._emit(Ev.REMOVE, parent_id=parent, entry_name=name,
                   recursive_remove=recursive, client_id=client_id)
        return result

    async def rename_at(self, sparent: int, sname: str, dparent: int,
                        dname: str, client_id: str = "",
                        request_id: str = "", flags: int = 0,
                        user: UserInfo | None = None) -> None:
        """Entry-level rename; flags use the renameat2(2)/FUSE values
        (1 = RENAME_NOREPLACE: fail with EEXIST when dst exists;
        2 = RENAME_EXCHANGE: atomically swap the two entries)."""
        async def fn(txn: Transaction):
            sdent = await self._get_dent(txn, sparent, sname)
            if sdent is None:
                raise make_error(StatusCode.META_NOT_FOUND, sname)
            await self._rename_dispatch(txn, sparent, sname, sdent,
                                        dparent, dname, client_id, flags,
                                        user=user)
        result = await self._txn_idem(fn, "rename", client_id, request_id)
        self._emit(Ev.RENAME, parent_id=sparent, entry_name=sname,
                   dst_parent_id=dparent, dst_entry_name=dname,
                   client_id=client_id)
        return result

    async def open_inode(self, inode_id: int, write: bool = False,
                         session_client: str = "",
                         user: UserInfo | None = None,
                         rdwr: bool = False) -> tuple[Inode, str]:
        """FUSE open by nodeid: like open_file but without a path walk."""
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            if inode.itype == InodeType.DIRECTORY and write:
                raise make_error(StatusCode.META_IS_DIR, str(inode_id))
            await self._check_access(txn, inode, user,
                                     self._open_bits(write, rdwr),
                                     str(inode_id))
            session_id = ""
            if write and session_client:
                session_id = str(uuidlib.uuid4())
                txn.set(FileSession.key(inode_id, session_id),
                        serde.dumps(FileSession(inode_id, session_id,
                                                session_client, time.time())))
            return inode, session_id
        inode, session_id = await self._txn(fn)
        if write:
            self._emit(Ev.OPEN_WRITE, inode_id=inode_id,
                       client_id=session_client)
        return inode, session_id

    async def batch_stat(self, paths: list[str],
                         follow: bool = True,
                         user: UserInfo | None = None) -> list[Inode | None]:
        """Stat many paths in ONE transaction (batchStatByPath,
        fbs/meta/Service.h:718-741) — one snapshot.  Permission-denied
        paths come back None, like not-found ones.

        Batched for the many-files-few-dirs shape (readdirplus, mdtest):
        each DISTINCT parent directory resolves once through the full
        resolver (symlinks + per-dir X checks), then every path's dirent
        and inode load ride ONE get_many each — so a sharded/remote KV
        pays O(dirs + touched shards) read RPCs, not O(paths) serial
        resolutions."""
        async def fn(txn: Transaction):
            out: list[Inode | None] = [None] * len(paths)
            groups: dict[str, list[tuple[int, str]]] = {}
            for idx, path in enumerate(paths):
                parts = [p for p in path.split("/") if p]
                if not parts:
                    try:
                        out[idx] = await self._require_inode(
                            txn, ROOT_INODE_ID)
                    except StatusError:
                        pass
                    continue
                groups.setdefault("/".join(parts[:-1]),
                                  []).append((idx, parts[-1]))
            dir_ids: dict[str, int | None] = {}
            for dirpath in groups:
                try:
                    if not dirpath:
                        pid: int | None = ROOT_INODE_ID
                    else:
                        _, _, dent = await self.resolve(
                            txn, dirpath, follow_last=True, user=user)
                        pid = (dent.inode_id
                               if dent is not None
                               and dent.itype == InodeType.DIRECTORY
                               else None)
                    if pid is not None:
                        # resolve checked X on the ANCESTORS; searching
                        # inside this dir needs X on it too
                        await self._check_access(txn, pid, user, acl.X,
                                                 dirpath or "/")
                    dir_ids[dirpath] = pid
                except StatusError:
                    dir_ids[dirpath] = None
            items = [(idx, pid, name)
                     for dirpath, members in groups.items()
                     if (pid := dir_ids[dirpath]) is not None
                     for idx, name in members]
            dent_raws = await txn.get_many(
                [DirEntry.key(pid, name) for _, pid, name in items])
            loads: list[tuple[int, int]] = []     # (out idx, inode id)
            for (idx, _pid, _name), raw in zip(items, dent_raws):
                if not raw:
                    continue
                dent: DirEntry = serde.loads(raw)
                if follow and dent.itype == InodeType.SYMLINK:
                    # symlink tail: the rare shape that needs the full
                    # per-path resolver (expansion limits, new ACL path)
                    try:
                        _, _, tail = await self.resolve(
                            txn, paths[idx], follow_last=True, user=user)
                        if tail is not None:
                            loads.append((idx, tail.inode_id))
                    except StatusError:
                        pass
                else:
                    loads.append((idx, dent.inode_id))
            inode_raws = await txn.get_many(
                [Inode.key(iid) for _, iid in loads])
            for (idx, _iid), raw in zip(loads, inode_raws):
                out[idx] = serde.loads(raw) if raw else None
            return out
        return await self._txn(fn)

    async def batch_stat_inodes(self, inode_ids: list[int]) -> list[Inode | None]:
        """Stat many inodes by id in one transaction (batchStat analog).
        get_many batches the whole id list into one read RPC per touched
        shard (per-key reads would cost a sharded batch_stat one RPC a key)."""
        async def fn(txn: Transaction):
            raws = await txn.get_many([Inode.key(i) for i in inode_ids])
            return [serde.loads(r) if r else None for r in raws]
        return await self._txn(fn)

    async def list_inodes(self, after_inode: int = 0,
                          limit: int = 1000) -> list[Inode]:
        """Raw inode-table page (DumpInodes analog); `after_inode` is the
        pagination cursor (exclusive)."""
        async def fn(txn: Transaction):
            begin = Inode.key(after_inode + 1) if after_inode else \
                KeyPrefix.INODE.value
            rows = await txn.get_range(begin, KeyPrefix.INODE.value + b"\xff",
                                       limit=limit, snapshot=True)
            return [serde.loads(v) for _, v in rows]
        return await self._txn(fn)

    async def list_dirents(self, after_parent: int = 0,
                           after_name: str = "",
                           limit: int = 1000) -> list[DirEntry]:
        """Raw dirent-table page (DumpDirEntries analog).  The cursor is
        the full (parent, name) KEY of the last row seen — parent-only
        granularity would skip the rest of a directory wider than one
        page."""
        async def fn(txn: Transaction):
            if after_parent or after_name:
                begin = DirEntry.key(after_parent, after_name) + b"\x00"
            else:
                begin = KeyPrefix.DENTRY.value
            rows = await txn.get_range(begin, KeyPrefix.DENTRY.value + b"\xff",
                                       limit=limit, snapshot=True)
            return [serde.loads(v) for _, v in rows]
        return await self._txn(fn)

    async def prune_idem_records(self, ttl_s: float,
                                 batch: int = 2048) -> int:
        """Expire idempotency records (the reference prunes by timestamp:
        a record only needs to outlive the client's retry horizon).

        Scans a bounded page per call from a rotating in-memory cursor —
        keys are request-id-random, so fresh records at the front must not
        pin the scan away from expired ones further in."""
        cutoff = time.time() - ttl_s
        begin = getattr(self, "_idem_cursor", IDEM_PREFIX)

        async def fn(txn: Transaction):
            rows = await txn.get_range(begin, IDEM_PREFIX + b"\xff",
                                       limit=batch, snapshot=True)
            dropped = 0
            for k, v in rows:
                rec: IdemRecord = serde.loads(v)
                if rec.timestamp < cutoff:
                    txn.clear(k)
                    dropped += 1
            nxt = rows[-1][0] + b"\x00" if len(rows) == batch else IDEM_PREFIX
            return dropped, nxt
        dropped, self._idem_cursor = await self._txn(fn)
        return dropped

    async def _link_body(self, txn: Transaction, src_inode_id: int,
                         parent: int, name: str, client_id: str,
                         user: UserInfo | None = None) -> Inode:
        """The single hardlink mutation rule, shared by the path op and the
        entry op.  POSIX: link() bumps the file's ctime ONLY (the data did
        not change — backup tools key on mtime)."""
        inode = await self._require_inode(txn, src_inode_id)
        if inode.itype == InodeType.DIRECTORY:
            raise make_error(StatusCode.META_IS_DIR, str(src_inode_id))
        if await self._get_dent(txn, parent, name) is not None:
            raise make_error(StatusCode.META_EXISTS, name)
        await self._require_unlocked_dir(txn, parent, client_id, name)
        await self._check_access(txn, parent, user, acl.W | acl.X, name)
        inode.nlink += 1
        inode.ctime = time.time()
        txn.set(Inode.key(src_inode_id), serde.dumps(inode))
        txn.set(DirEntry.key(parent, name), serde.dumps(
            DirEntry(parent, name, src_inode_id, inode.itype)))
        return inode

    async def hardlink(self, existing: str, new_path: str,
                       client_id: str = "", request_id: str = "",
                       user: UserInfo | None = None) -> Inode:
        async def fn(txn: Transaction):
            _, _, src = await self.resolve(txn, existing, user=user)
            if src is None:
                raise make_error(StatusCode.META_NOT_FOUND, existing)
            parent, name, dent = await self.resolve(txn, new_path,
                                                    follow_last=False,
                                                    user=user)
            if dent is not None:
                raise make_error(StatusCode.META_EXISTS, new_path)
            return await self._link_body(txn, src.inode_id, parent, name,
                                         client_id, user=user)
        inode = await self._txn_idem(fn, "hardlink", client_id, request_id)
        self._emit(Ev.HARDLINK, inode_id=inode.inode_id, entry_name=new_path,
                   nlink=inode.nlink, client_id=client_id)
        return inode

    async def link_at(self, inode_id: int, parent: int, name: str,
                      client_id: str = "", request_id: str = "",
                      user: UserInfo | None = None) -> Inode:
        """Entry-level hardlink (FUSE LINK: existing nodeid -> (parent,
        name)); shares the mutation rule with the path op."""
        async def fn(txn: Transaction):
            return await self._link_body(txn, inode_id, parent, name,
                                         client_id, user=user)
        inode = await self._txn_idem(fn, "link_at", client_id, request_id)
        self._emit(Ev.HARDLINK, inode_id=inode.inode_id, parent_id=parent,
                   entry_name=name, nlink=inode.nlink, client_id=client_id)
        return inode

    async def _rename_dispatch(self, txn: Transaction, sparent: int,
                               sname: str, sdent: DirEntry, dparent: int,
                               dname: str, client_id: str,
                               flags: int,
                               user: UserInfo | None = None) -> None:
        """Shared renameat2 flag dispatch for the path- and entry-level
        ops (one implementation owns the semantics)."""
        if flags == 2:
            await self._exchange_body(txn, sparent, sname, sdent,
                                      dparent, dname, client_id, user=user)
        elif flags in (0, 1):
            await self._rename_body(txn, sparent, sname, sdent,
                                    dparent, dname, client_id,
                                    no_replace=flags == 1, user=user)
        else:
            raise make_error(StatusCode.INVALID_ARG,
                             f"bad rename flags {flags:#x}")

    async def _require_no_cycle(self, txn: Transaction, moved: DirEntry,
                                new_parent: int, what: str) -> None:
        """POSIX rename(2)/renameat2 EINVAL: a directory may not move (or
        be exchanged) into its own subtree.  Walk the new parent's
        ancestry; hitting the moved directory means the destination is
        inside it."""
        if moved.itype != InodeType.DIRECTORY:
            return
        cur = new_parent
        while cur != ROOT_INODE_ID:
            if cur == moved.inode_id:
                raise make_error(StatusCode.INVALID_ARG, what)
            cur = (await self._require_inode(txn, cur)).parent

    async def _rename_body(self, txn: Transaction, sparent: int, sname: str,
                           sdent: DirEntry, dparent: int, dname: str,
                           client_id: str, no_replace: bool = False,
                           user: UserInfo | None = None) -> None:
        await self._require_unlocked_dir(txn, sparent, client_id, sname)
        if dparent != sparent:
            await self._require_unlocked_dir(txn, dparent, client_id, dname)
        # rename(2): removing the src entry needs W+X on its parent (+
        # sticky); creating/overwriting dst needs W+X on the dst parent
        await self._check_unlink_perm(txn, sparent, sdent, user, sname)
        if dparent != sparent:
            await self._check_access(txn, dparent, user, acl.W | acl.X,
                                     dname)
        # without the walk the move would orphan (and leak) the subtree
        await self._require_no_cycle(
            txn, sdent, dparent,
            f"cannot move directory {sname!r} into its own subtree")
        ddent = await self._get_dent(txn, dparent, dname)
        if ddent is not None:
            if no_replace:
                # RENAME_NOREPLACE: any existing dst (even a hardlink
                # alias of src) is EEXIST, before the same-inode no-op
                raise make_error(StatusCode.META_EXISTS, dname)
            if ddent.inode_id == sdent.inode_id:
                # POSIX: src and dst resolve to the same file (same entry or
                # hardlink alias) -> no-op; unlink-then-relink would destroy
                # the last link and dangle the new entry
                return
            if ddent.itype == InodeType.DIRECTORY:
                if sdent.itype != InodeType.DIRECTORY:
                    # POSIX rename(2): non-dir over dir is EISDIR
                    raise make_error(StatusCode.META_IS_DIR, dname)
                # overwriting a locked (even empty) directory destroys it
                await self._require_unlocked_dir(txn, ddent.inode_id,
                                                 client_id, dname)
                pre = DirEntry.prefix(ddent.inode_id)
                if await txn.get_range(pre, pre + b"\xff", limit=1):
                    raise make_error(StatusCode.META_NOT_EMPTY, dname)
            elif sdent.itype == InodeType.DIRECTORY:
                # POSIX: dir over non-dir is ENOTDIR
                raise make_error(StatusCode.META_NOT_DIR, dname)
            # overwrite: unlink destination (sticky rule applies to it)
            await self._check_unlink_perm(txn, dparent, ddent, user, dname)
            await self._unlink_entry(txn, ddent)
        txn.clear(DirEntry.key(sparent, sname))
        txn.set(DirEntry.key(dparent, dname), serde.dumps(
            DirEntry(dparent, dname, sdent.inode_id, sdent.itype)))
        if sdent.itype == InodeType.DIRECTORY:
            inode = await self._require_inode(txn, sdent.inode_id)
            inode.parent = dparent
            txn.set(Inode.key(inode.inode_id), serde.dumps(inode))

    async def _exchange_body(self, txn: Transaction, sparent: int,
                             sname: str, sdent: DirEntry, dparent: int,
                             dname: str, client_id: str,
                             user: UserInfo | None = None) -> None:
        """RENAME_EXCHANGE: atomically swap two existing entries (types may
        differ).  The VFS blocks ancestor/descendant exchanges on a real
        mount; the same EINVAL is enforced here for direct API callers."""
        await self._require_unlocked_dir(txn, sparent, client_id, sname)
        if dparent != sparent:
            await self._require_unlocked_dir(txn, dparent, client_id, dname)
        ddent = await self._get_dent(txn, dparent, dname)
        if ddent is None:
            raise make_error(StatusCode.META_NOT_FOUND, dname)
        # both entries move: W+X (+ sticky) on both parents
        await self._check_unlink_perm(txn, sparent, sdent, user, sname)
        await self._check_unlink_perm(txn, dparent, ddent, user, dname)
        if ddent.inode_id == sdent.inode_id:
            return                         # aliases of one inode: no-op
        for moved, new_parent in ((sdent, dparent), (ddent, sparent)):
            await self._require_no_cycle(
                txn, moved, new_parent,
                f"exchange of {sname!r} and {dname!r} would create a "
                f"cycle")
        txn.set(DirEntry.key(sparent, sname), serde.dumps(
            DirEntry(sparent, sname, ddent.inode_id, ddent.itype)))
        txn.set(DirEntry.key(dparent, dname), serde.dumps(
            DirEntry(dparent, dname, sdent.inode_id, sdent.itype)))
        if sparent != dparent:
            for dent, new_parent in ((sdent, dparent), (ddent, sparent)):
                if dent.itype == InodeType.DIRECTORY:
                    inode = await self._require_inode(txn, dent.inode_id)
                    inode.parent = new_parent
                    txn.set(Inode.key(inode.inode_id), serde.dumps(inode))

    async def rename(self, src: str, dst: str,
                     client_id: str = "", request_id: str = "",
                     flags: int = 0, user: UserInfo | None = None) -> None:
        """Path-level rename; flags as in rename_at (renameat2 values:
        1 = NOREPLACE, 2 = EXCHANGE)."""
        async def fn(txn: Transaction):
            sparent, sname, sdent = await self.resolve(txn, src,
                                                       follow_last=False,
                                                       user=user)
            if sdent is None:
                raise make_error(StatusCode.META_NOT_FOUND, src)
            dparent, dname, _ = await self.resolve(txn, dst,
                                                   follow_last=False,
                                                   user=user)
            await self._rename_dispatch(txn, sparent, sname, sdent,
                                        dparent, dname, client_id, flags,
                                        user=user)
        result = await self._txn_idem(fn, "rename", client_id, request_id)
        self._emit(Ev.RENAME, entry_name=src, dst_entry_name=dst,
                   client_id=client_id)
        return result

    async def _unlink_entry(self, txn: Transaction, dent: DirEntry) -> None:
        inode = await self._get_inode(txn, dent.inode_id)
        if inode is None:
            return
        inode.nlink -= 1
        if inode.itype == InodeType.DIRECTORY:
            inode.nlink -= 1  # ".." style accounting
        if inode.nlink <= 0 or inode.itype == InodeType.DIRECTORY:
            txn.clear(Inode.key(inode.inode_id))
            if inode.itype == InodeType.FILE and inode.layout is not None:
                # enqueue chunk reclamation (GcManager analog)
                txn.set(gc_key(inode.inode_id), serde.dumps(inode))
        else:
            inode.touch()
            txn.set(Inode.key(inode.inode_id), serde.dumps(inode))

    async def remove(self, path: str, recursive: bool = False,
                     client_id: str = "", request_id: str = "",
                     user: UserInfo | None = None) -> None:
        # recursive removal runs inside one txn (small trees); big trees
        # should go through trash + async GC
        async def fn(txn: Transaction):
            parent, name, dent = await self.resolve(txn, path,
                                                    follow_last=False,
                                                    user=user)
            if dent is None:
                raise make_error(StatusCode.META_NOT_FOUND, path)
            await self._unlink_body(txn, parent, name, dent, recursive,
                                    client_id, user=user)
        result = await self._txn_idem(fn, "remove", client_id, request_id)
        self._emit(Ev.REMOVE, entry_name=path, recursive_remove=recursive,
                   client_id=client_id)
        return result

    async def _remove_tree(self, txn: Transaction, dent: DirEntry,
                           client_id: str = "",
                           user: UserInfo | None = None) -> None:
        if dent.itype == InodeType.DIRECTORY:
            await self._require_unlocked_dir(txn, dent.inode_id, client_id,
                                             dent.name)
            # recursive delete: every directory whose entries go needs W+X
            # (rm -r semantics — one unwritable subdir fails the txn whole)
            await self._check_access(txn, dent.inode_id, user,
                                     acl.W | acl.X, dent.name)
            pre = DirEntry.prefix(dent.inode_id)
            for _, raw in await txn.get_range(pre, pre + b"\xff"):
                child: DirEntry = serde.loads(raw)
                await self._remove_tree(txn, child, client_id, user=user)
                txn.clear(DirEntry.key(child.parent, child.name))
        await self._unlink_entry(txn, dent)

    @staticmethod
    def _apply_attrs(inode: Inode, *, perm=None, uid=None, gid=None,
                     atime=None, mtime=None) -> Inode:
        """The single attr-mutation rule (POSIX: attribute changes bump
        ctime only; an explicit utimens mtime is user data, not a bump)."""
        if perm is not None:
            inode.perm = perm & 0o7777
        if uid is not None:
            inode.uid = uid
        if gid is not None:
            inode.gid = gid
        if atime is not None:
            inode.atime = atime
        if mtime is not None:
            inode.mtime = mtime
        inode.ctime = time.time()
        return inode

    @staticmethod
    def _check_setattr_perm(inode: Inode, user: UserInfo | None, *,
                            perm, uid, gid, atime=None, mtime=None,
                            path: str = "") -> None:
        """setattr gate (reference SetAttr.h:76,99): chmod is owner-only;
        chown follows chown(2) rules; explicit utimes are owner-only
        unless the caller has W (the touch(1) rule)."""
        if user is None or acl.is_root(user):
            return
        if perm is not None:
            acl.check_owner(inode, user, "chmod", path)
        acl.check_chown(inode, user, uid, gid, path)
        if (atime is not None or mtime is not None) \
                and user.uid != inode.uid:
            acl.check(inode, user, acl.W, path)

    async def set_attr(self, path: str, *, perm: int | None = None,
                       uid: int | None = None, gid: int | None = None,
                       user: UserInfo | None = None) -> Inode:
        async def fn(txn: Transaction):
            parent, name, dent = await self.resolve(txn, path, user=user)
            if dent is None:
                raise make_error(StatusCode.META_NOT_FOUND, path)
            inode = await self._require_inode(txn, dent.inode_id)
            self._check_setattr_perm(inode, user, perm=perm, uid=uid,
                                     gid=gid, path=path)
            self._apply_attrs(inode, perm=perm, uid=uid, gid=gid)
            txn.set(Inode.key(inode.inode_id), serde.dumps(inode))
            return inode
        return await self._txn(fn)

    async def set_attr_inode(self, inode_id: int, *,
                             perm: int | None = None,
                             uid: int | None = None,
                             gid: int | None = None,
                             atime: float | None = None,
                             mtime: float | None = None,
                             user: UserInfo | None = None) -> Inode:
        """Inode-addressed setattr (the FUSE lowlevel surface: chmod/chown/
        utimens arrive by nodeid, not path — reference FuseOps setattr)."""
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            self._check_setattr_perm(inode, user, perm=perm, uid=uid,
                                     gid=gid, atime=atime, mtime=mtime,
                                     path=str(inode_id))
            self._apply_attrs(inode, perm=perm, uid=uid, gid=gid,
                              atime=atime, mtime=mtime)
            txn.set(Inode.key(inode_id), serde.dumps(inode))
            return inode
        return await self._txn(fn)

    async def set_length(self, inode_id: int, length: int) -> Inode:
        async def fn(txn: Transaction):
            inode = await self._require_inode(txn, inode_id)
            inode.length = length
            inode.length_hint = min(inode.length_hint, length)
            inode.touch()
            txn.set(Inode.key(inode_id), serde.dumps(inode))
            return inode
        return await self._txn(fn)

    async def get_real_path(self, inode_id: int) -> str:
        """Walk parents to the root (GetRealPath analog). Only exact for
        directories; files report their first dirent match."""
        async def fn(txn: Transaction):
            segments: list[str] = []
            cur = inode_id
            for _ in range(256):
                if cur == ROOT_INODE_ID:
                    return "/" + "/".join(reversed(segments))
                inode = await self._require_inode(txn, cur)
                parent = inode.parent
                pre = DirEntry.prefix(parent)
                found = None
                for _, raw in await txn.get_range(pre, pre + b"\xff"):
                    d: DirEntry = serde.loads(raw)
                    if d.inode_id == cur:
                        found = d
                        break
                if found is None:
                    raise make_error(StatusCode.META_NOT_FOUND,
                                     f"inode {cur} orphaned")
                segments.append(found.name)
                cur = parent
            raise make_error(StatusCode.META_INVALID_PATH, "loop")
        return await self._txn(fn)

    # --- sessions & GC ---

    async def sessions_of(self, inode_id: int) -> list[FileSession]:
        txn = self.kv.transaction()
        pre = FileSession.prefix(inode_id)
        return [serde.loads(v) for _, v in
                await txn.get_range(pre, pre + b"\xff", snapshot=True)]

    async def prune_sessions(self, ttl_s: float) -> int:
        """Drop write sessions older than ttl (SessionManager.h:44-83 analog:
        dead clients must not pin deferred deletions forever).  Live clients
        are expected to refresh/close well within the ttl."""
        return len(await self.prune_sessions_report(ttl_s))

    async def prune_sessions_report(self, ttl_s: float) -> list[int]:
        """Like prune_sessions, but returns the affected inode ids so the
        caller can reconcile their lengths: a crashed writer's close never
        ran, so the settled length may trail what storage actually holds
        (docs/design_notes.md:91-95 — Distributor length reconciliation)."""
        cutoff = time.time() - ttl_s
        sessions = await self.scan_sessions()
        return await self.clear_sessions(
            [s for s in sessions if s.created_at < cutoff])

    async def scan_sessions(self) -> list[FileSession]:
        """Snapshot of all write sessions (one range scan; the prune tick
        derives both TTL expiry and dead-client sets from it)."""
        async def fn(txn: Transaction):
            pre = KeyPrefix.INODE_SESSION.value
            rows = await txn.get_range(pre, pre + b"\xff", snapshot=True)
            return [serde.loads(v) for _, v in rows]
        return await self._txn(fn)

    async def clear_sessions(self, sessions: list[FileSession]) -> list[int]:
        """Remove the given sessions; returns affected inode ids (callers
        reconcile their lengths — a reaped writer's close never ran)."""
        if not sessions:
            return []

        async def fn(txn: Transaction):
            for s in sessions:
                txn.clear(FileSession.key(s.inode_id, s.session_id))
            return [s.inode_id for s in sessions]
        return await self._txn(fn)

    async def prune_dead_client_sessions(
            self, dead_clients: set[str]) -> list[int]:
        """Prune write sessions of clients CONFIRMED dead
        (MgmtdClientSessionsChecker analog, SessionManager.h:44-83).  The
        caller decides deadness — a client must be absent from mgmtd's
        registry for a full grace period, not merely missing at one
        observation (a mgmtd failover or a client<->mgmtd blip must not
        reap a healthy mount's sessions)."""
        if not dead_clients:
            return []
        sessions = await self.scan_sessions()
        return await self.clear_sessions(
            [s for s in sessions if s.client_id in dead_clients])

    async def gc_pop(self, limit: int = 16, owned=None) -> list[Inode]:
        """Dequeue inodes whose chunks need reclamation.  `owned` filters by
        the Distributor's rendezvous ownership so concurrent meta servers
        partition the GC queue instead of racing on it."""
        async def fn(txn: Transaction):
            rows = await txn.get_range(GC_PREFIX, GC_PREFIX + b"\xff", limit=limit)
            out = []
            for k, v in rows:
                inode: Inode = serde.loads(v)
                if owned is not None and not owned(inode.inode_id):
                    continue
                # skip (keep queued) while write sessions remain
                spre = FileSession.prefix(inode.inode_id)
                if await txn.get_range(spre, spre + b"\xff", limit=1):
                    continue
                txn.clear(k)
                out.append(inode)
            return out
        return await self._txn(fn)
