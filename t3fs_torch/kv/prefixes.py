"""Key-prefix table for the shared transactional KV (reference:
common/kv/KeyPrefix-def.h:6-7 — "INOD", "DENT", ... 4-byte prefixes).

The port of t3fs/kv/prefixes.py."""

import enum


class KeyPrefix(bytes, enum.Enum):
    INODE = b"INOD"
    DENTRY = b"DENT"
    INODE_SESSION = b"INOS"      # file write sessions
    CHAIN = b"CHAN"              # mgmtd chain records
    CHAIN_TABLE = b"CHTB"
    NODE = b"NODE"               # mgmtd node records
    LEASE = b"LEAS"              # mgmtd primary lease
    CONFIG = b"CONF"             # distributed config templates
    ROUTING_VER = b"ROUV"
    IDEMPOTENT = b"IDEM"         # meta request dedupe records
    ALLOCATOR = b"ALOC"          # inode-id allocator state
    USER = b"USER"
    CLIENT_SESSION = b"CSES"     # mgmtd client sessions (fbs/mgmtd/ClientSession.h)
    TARGET_INFO = b"TGTI"        # mgmtd per-target info (MgmtdTargetInfoPersister)
    UNIVERSAL_TAGS = b"UTAG"     # mgmtd cluster-wide tags (setUniversalTags)

    def key(self, *parts: bytes) -> bytes:
        return self.value + b"".join(parts)
