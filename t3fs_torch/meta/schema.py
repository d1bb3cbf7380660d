"""Meta schema: inode + dirent records and their KV encoding.

Reference analogs: fbs/meta/Schema.h:331-399 (File/Directory/Symlink inode
types, layout = chainTable+chunkSize+stripeSize+seed), meta/store/Inode.cc /
DirEntry.cc KV encoding "INOD"+inodeId / "DENT"+parentId+name
(common/kv/KeyPrefix-def.h:6-7, docs/design_notes.md:65,75).

The port of t3fs/meta/schema.py; its structs serialize to the reference's bytes.
"""

from __future__ import annotations

import enum
import struct
import time
from dataclasses import dataclass, field

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.kv.prefixes import KeyPrefix
from t3fs_torch.utils.serde import serde_struct

ROOT_INODE_ID = 1


class InodeType(enum.IntEnum):
    FILE = 1
    DIRECTORY = 2
    SYMLINK = 3


@serde_struct
@dataclass
class Inode:
    inode_id: int = 0
    itype: InodeType = InodeType.FILE
    perm: int = 0o644
    uid: int = 0
    gid: int = 0
    nlink: int = 1
    atime: float = 0.0
    mtime: float = 0.0
    ctime: float = 0.0
    # FILE
    layout: FileLayout | None = None
    length: int = 0
    length_hint: int = 0       # max reported write position (design_notes:91-95)
    # SYMLINK
    symlink_target: str = ""
    # DIRECTORY
    parent: int = 0
    # lockDirectory (fbs/meta/Service.h LockDirectoryReq): while set, entry
    # mutations under this directory are rejected for other clients
    dir_lock: str = ""

    @staticmethod
    def key(inode_id: int) -> bytes:
        return KeyPrefix.INODE.key(struct.pack(">Q", inode_id))

    def touch(self) -> "Inode":
        self.mtime = self.ctime = time.time()
        if not self.atime:
            # initialize unset atime on first mutation.  Epoch-0 atime is
            # out of contract (indistinguishable from unset; the FUSE attr
            # displays mtime for it and SETATTR clamps negatives to 0)
            self.atime = self.mtime
        return self


@serde_struct
@dataclass
class DirEntry:
    parent: int = 0
    name: str = ""
    inode_id: int = 0
    itype: InodeType = InodeType.FILE

    @staticmethod
    def key(parent: int, name: str) -> bytes:
        return KeyPrefix.DENTRY.key(struct.pack(">Q", parent), name.encode())

    @staticmethod
    def prefix(parent: int) -> bytes:
        return KeyPrefix.DENTRY.key(struct.pack(">Q", parent))


@serde_struct
@dataclass
class FileSession:
    """Write-open session enabling deferred deletion
    (meta/store/FileSession.h, docs/design_notes.md:89)."""
    inode_id: int = 0
    session_id: str = ""
    client_id: str = ""
    created_at: float = 0.0

    @staticmethod
    def key(inode_id: int, session_id: str) -> bytes:
        return KeyPrefix.INODE_SESSION.key(struct.pack(">Q", inode_id),
                                           session_id.encode())

    @staticmethod
    def prefix(inode_id: int) -> bytes:
        return KeyPrefix.INODE_SESSION.key(struct.pack(">Q", inode_id))


def gc_key(inode_id: int) -> bytes:
    """GC queue entry for a removed file awaiting chunk reclamation
    (GcManager analog, meta/components/GcManager.h:57-118)."""
    return KeyPrefix.IDEMPOTENT.key(b"GC", struct.pack(">Q", inode_id))


GC_PREFIX = KeyPrefix.IDEMPOTENT.key(b"GC")


@serde_struct
@dataclass
class IdemRecord:
    """Recorded outcome of a mutating meta op, keyed by (request_id,
    client_id) — the retry of an already-committed mutation returns the
    recorded result instead of re-applying or failing confusingly
    (reference meta/store/Idempotent.h: Record keyed requestId+clientId)."""
    client_id: str = ""
    request_id: str = ""
    timestamp: float = 0.0
    op: str = ""
    inode: Inode | None = None      # result payload where the op returns one
    extra: str = ""                 # e.g. the session_id a create minted


def idem_key(request_id: str, client_id: str) -> bytes:
    # requestId first to avoid a per-client hotspot (Idempotent.h packKey)
    return KeyPrefix.IDEMPOTENT.key(b"RQ", request_id.encode(), b"@",
                                    client_id.encode())


IDEM_PREFIX = KeyPrefix.IDEMPOTENT.key(b"RQ")
