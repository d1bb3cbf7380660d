"""MetaClient: typed wrapper over the Meta service with server selection.

Reference analogs: client/meta/MetaClient.{h,cc} (typed ops, retries),
ServerSelectionStrategy.h (random/round-robin with failover across the
stateless meta servers).

The port of t3fs/client/meta_client.py.
"""

from __future__ import annotations

import itertools
import logging
import random
import uuid as uuidlib

from t3fs_torch.meta.acl import UserInfo
from t3fs_torch.meta.schema import DirEntry, Inode, InodeType
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode
from t3fs_torch.meta.service import (
    BatchStatReq, EntryReq, InodeReq, LockDirReq, PathReq, PruneSessionReq,
    SetAttrReq,
)
from t3fs_torch.net.client import Client
from t3fs_torch.utils.status import StatusError

log = logging.getLogger("t3fs_torch.client.meta")


class MetaClient:
    def __init__(self, addresses: list[str], client: Client | None = None,
                 client_id: str = "", strategy: str = "roundrobin",
                 max_retries: int = 3, user: UserInfo | None = None):
        assert addresses
        self.addresses = list(addresses)
        self.client = client or Client()
        self.client_id = client_id or f"mc-{random.getrandbits(40):010x}"
        self.strategy = strategy
        self.max_retries = max_retries
        # default identity stamped on every request (None = trusted
        # caller, enforcement off); per-call `user=` overrides it — the
        # FUSE daemon passes each kernel request's caller this way
        self.user = user
        self._rr = itertools.count()

    def _pick(self, attempt: int) -> str:
        if self.strategy == "random" and attempt == 0:
            return random.choice(self.addresses)
        return self.addresses[(next(self._rr) + attempt) % len(self.addresses)]

    async def _call(self, method: str, req, user: UserInfo | None = None):
        ident = user if user is not None else self.user
        if ident is not None and hasattr(req, "user"):
            req.user = ident
        last: StatusError | None = None
        for attempt in range(self.max_retries):
            address = self._pick(attempt)
            try:
                rsp, _ = await self.client.call(address, f"Meta.{method}", req)
                return rsp
            except StatusError as e:
                if not e.status.retryable:
                    raise
                last = e
        raise last

    # --- typed ops ---

    async def stat(self, path: str, follow: bool = True,
                   user: UserInfo | None = None) -> Inode:
        return (await self._call("stat", PathReq(path=path, follow=follow),
                                 user=user)).inode

    async def stat_inode(self, inode_id: int) -> Inode:
        return (await self._call("stat_inode", InodeReq(inode_id=inode_id))).inode

    def _rid(self) -> str:
        """Fresh idempotency key; reused across the retries of ONE logical
        mutation so a replay returns the recorded result (Idempotent.h)."""
        return str(uuidlib.uuid4())

    async def create(self, path: str, perm: int = 0o644, chunk_size: int = 0,
                     stripe: int = 0, write: bool = False,
                     user: UserInfo | None = None) -> tuple[Inode, str]:
        """write=True opens a write session with the create (O_CREAT|O_WRONLY);
        the caller must close(inode_id, session_id) or the session pins GC
        until the dead-client pruner reaps it."""
        rsp = await self._call("create", PathReq(
            path=path, perm=perm, chunk_size=chunk_size, stripe=stripe,
            write=write, client_id=self.client_id, request_id=self._rid()),
            user=user)
        return rsp.inode, rsp.session_id

    async def open(self, path: str, write: bool = False,
                   user: UserInfo | None = None,
                   rdwr: bool = False) -> tuple[Inode, str]:
        rsp = await self._call("open", PathReq(path=path, write=write,
                                               client_id=self.client_id,
                                               rdwr=rdwr),
                               user=user)
        return rsp.inode, rsp.session_id

    async def close(self, inode_id: int, session_id: str = "",
                    length: int = -1) -> Inode:
        return (await self._call("close", InodeReq(
            inode_id=inode_id, session_id=session_id, length=length))).inode

    async def sync(self, inode_id: int) -> Inode:
        return (await self._call("sync", InodeReq(inode_id=inode_id))).inode

    async def report_write_position(self, inode_id: int, position: int) -> None:
        await self._call("report_write_position",
                         InodeReq(inode_id=inode_id, position=position))

    async def mkdirs(self, path: str, perm: int = 0o755,
                     recursive: bool = True,
                     user: UserInfo | None = None) -> Inode:
        return (await self._call("mkdirs", PathReq(
            path=path, perm=perm, recursive=recursive,
            client_id=self.client_id, request_id=self._rid()),
            user=user)).inode

    async def readdir(self, path: str,
                      user: UserInfo | None = None) -> list[DirEntry]:
        return (await self._call("readdir", PathReq(path=path),
                                 user=user)).entries

    async def remove(self, path: str, recursive: bool = False,
                     user: UserInfo | None = None) -> None:
        await self._call("remove", PathReq(
            path=path, recursive=recursive, client_id=self.client_id,
            request_id=self._rid()), user=user)

    async def rename(self, src: str, dst: str, flags: int = 0,
                     user: UserInfo | None = None) -> None:
        # flags route to a separate method so an old server can never
        # mis-run a flagged rename as a plain destructive one
        await self._call("rename2" if flags else "rename", PathReq(
            path=src, target=dst, flags=flags, client_id=self.client_id,
            request_id=self._rid()), user=user)

    async def symlink(self, path: str, target: str,
                      user: UserInfo | None = None) -> Inode:
        return (await self._call("symlink", PathReq(
            path=path, target=target, client_id=self.client_id,
            request_id=self._rid()), user=user)).inode

    async def hardlink(self, existing: str, new_path: str,
                       user: UserInfo | None = None) -> Inode:
        return (await self._call("hardlink", PathReq(
            path=existing, target=new_path, client_id=self.client_id,
            request_id=self._rid()), user=user)).inode

    async def set_attr(self, path: str, perm: int,
                       user: UserInfo | None = None) -> Inode:
        return (await self._call("set_attr",
                                 PathReq(path=path, perm=perm),
                                 user=user)).inode

    async def truncate(self, inode_id: int, length: int,
                       user: UserInfo | None = None) -> Inode:
        return (await self._call("truncate", InodeReq(inode_id=inode_id,
                                                      length=length),
                                 user=user)).inode

    async def get_real_path(self, inode_id: int) -> str:
        return (await self._call("get_real_path", InodeReq(inode_id=inode_id))).path

    async def lookup(self, parent: int, name: str,
                     user: UserInfo | None = None) -> Inode:
        return (await self._call("lookup", EntryReq(
            parent=parent, name=name), user=user)).inode

    async def readdir_plus(self, inode_id: int, limit: int = 0,
                           user: UserInfo | None = None):
        """One-RPC listing: (dir inode, entries, entry inodes) from one
        snapshot — the FUSE OPENDIR hot path.  Falls back to the 3-RPC
        shape against an older meta server."""
        try:
            rsp = await self._call("readdir_plus",
                                   EntryReq(inode_id=inode_id, limit=limit),
                                   user=user)
            entries = [DirEntry(inode_id, n, i, InodeType(t))
                       for n, i, t in zip(rsp.names, rsp.ids, rsp.types)]
            return rsp.dir, entries, serde.loads_many(rsp.inode_blobs,
                                                      Inode)
        except StatusError as e:
            if e.code != StatusCode.RPC_METHOD_NOT_FOUND:
                raise
        entries = await self.readdir_inode(inode_id, limit, user=user)
        dir_inode = await self.stat_inode(inode_id)
        inodes = await self.batch_stat_inodes(
            [e.inode_id for e in entries]) if entries else []
        return dir_inode, entries, inodes

    async def readdir_inode(self, inode_id: int, limit: int = 0,
                            user: UserInfo | None = None
                            ) -> list[DirEntry]:
        return (await self._call("readdir_inode", EntryReq(
            inode_id=inode_id, limit=limit), user=user)).entries

    async def create_at(self, parent: int, name: str, perm: int = 0o644,
                        chunk_size: int = 0, stripe: int = 0,
                        write: bool = False,
                        user: UserInfo | None = None) -> tuple[Inode, str]:
        rsp = await self._call("create_at", EntryReq(
            parent=parent, name=name, perm=perm, chunk_size=chunk_size,
            stripe=stripe, write=write, client_id=self.client_id,
            request_id=self._rid()), user=user)
        return rsp.inode, rsp.session_id

    async def mkdir_at(self, parent: int, name: str, perm: int = 0o755,
                       user: UserInfo | None = None) -> Inode:
        return (await self._call("mkdir_at", EntryReq(
            parent=parent, name=name, perm=perm, client_id=self.client_id,
            request_id=self._rid()), user=user)).inode

    async def symlink_at(self, parent: int, name: str, target: str,
                         user: UserInfo | None = None) -> Inode:
        return (await self._call("symlink_at", EntryReq(
            parent=parent, name=name, target=target,
            client_id=self.client_id, request_id=self._rid()),
            user=user)).inode

    async def unlink_at(self, parent: int, name: str,
                        recursive: bool = False,
                        must_dir: bool | None = None,
                        user: UserInfo | None = None) -> None:
        await self._call("unlink_at", EntryReq(
            parent=parent, name=name, recursive=recursive,
            client_id=self.client_id, request_id=self._rid(),
            must_dir=-1 if must_dir is None else int(must_dir)),
            user=user)

    async def rename_at(self, sparent: int, sname: str, dparent: int,
                        dname: str, flags: int = 0,
                        user: UserInfo | None = None) -> None:
        """flags: renameat2(2) RENAME_NOREPLACE=1 / RENAME_EXCHANGE=2
        (flagged calls use their own method — see rename)."""
        await self._call("rename2_at" if flags else "rename_at", EntryReq(
            parent=sparent, name=sname, dparent=dparent, dname=dname,
            client_id=self.client_id, request_id=self._rid(),
            flags=flags), user=user)

    async def link_at(self, inode_id: int, parent: int, name: str,
                      user: UserInfo | None = None) -> Inode:
        return (await self._call("link_at", EntryReq(
            inode_id=inode_id, parent=parent, name=name,
            client_id=self.client_id, request_id=self._rid()),
            user=user)).inode

    async def open_inode(self, inode_id: int, write: bool = False,
                         user: UserInfo | None = None,
                         rdwr: bool = False) -> tuple[Inode, str]:
        rsp = await self._call("open_inode", EntryReq(
            inode_id=inode_id, write=write, client_id=self.client_id,
            rdwr=rdwr),
            user=user)
        return rsp.inode, rsp.session_id

    async def lock_directory(self, path: str, unlock: bool = False) -> Inode:
        return (await self._call("lock_directory", PathReq(
            path=path, client_id=self.client_id, unlock=unlock))).inode

    async def lock_directory_inode(self, inode_id: int,
                                   action: str) -> Inode:
        """try_lock | preempt_lock | unlock | clear on a directory nodeid
        (LockDirectory.cc:32-56); owner is this client's identity."""
        return (await self._call("lock_directory_inode", LockDirReq(
            inode_id=inode_id, client_id=self.client_id,
            action=action))).inode

    async def batch_stat(self, paths: list[str], follow: bool = True,
                         user: UserInfo | None = None
                         ) -> list[Inode | None]:
        return (await self._call("batch_stat", BatchStatReq(
            paths=paths, follow=follow), user=user)).inodes

    async def batch_stat_inodes(self, inode_ids: list[int]) -> list[Inode | None]:
        return (await self._call("batch_stat", BatchStatReq(
            inode_ids=inode_ids))).inodes

    async def set_attr_inode(self, inode_id: int, *, perm: int = -1,
                             uid: int = -1, gid: int = -1,
                             atime: float = -1.0,
                             mtime: float = -1.0,
                             user: UserInfo | None = None) -> Inode:
        """chmod/chown/utimens by nodeid (-1 = leave unchanged)."""
        return (await self._call("set_attr_inode", SetAttrReq(
            inode_id=inode_id, perm=perm, uid=uid, gid=gid,
            atime=atime, mtime=mtime), user=user)).inode

    async def prune_sessions(self, session_ids: list[str] = ()) -> None:
        """Release this client's write sessions eagerly (reference
        PruneSession): an unmounting daemon calls this instead of leaving
        its sessions to the dead-client reaper."""
        await self._call("prune_session", PruneSessionReq(
            client_id=self.client_id, session_ids=list(session_ids)))

    async def close_conn(self) -> None:
        await self.client.close()
