"""Distributor: rendezvous-hash assignment of background duties across meta
servers.

Reference analog: src/meta/components/Distributor.h:29 — stateless meta
servers shard background work (file-length reconciliation, GC, session
pruning) by highest-random-weight hashing over the live server set, so no
two servers fight over the same inode and a server's share redistributes
automatically when membership changes (docs/design_notes.md:95).

The port of t3fs/meta/distributor.py.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Iterable


def _weight(node_id: int, key: bytes) -> int:
    h = hashlib.blake2b(b"%d:" % node_id + key, digest_size=8)
    return int.from_bytes(h.digest(), "big")


class Distributor:
    def __init__(self, self_node_id: int,
                 servers_provider: Callable[[], Iterable[int]] | None = None):
        """servers_provider returns the CURRENT meta-server node ids (e.g.
        from the mgmtd routing's node records); None/empty means this server
        runs alone and owns everything."""
        self.self_node_id = self_node_id
        self.servers_provider = servers_provider

    def servers(self) -> list[int]:
        ids = sorted(self.servers_provider()) if self.servers_provider else []
        return ids or [self.self_node_id]

    def owner(self, key: int | str | bytes) -> int:
        if isinstance(key, int):
            key = b"%d" % key
        elif isinstance(key, str):
            key = key.encode()
        return max(self.servers(), key=lambda nid: _weight(nid, key))

    def is_mine(self, key: int | str | bytes) -> bool:
        return self.owner(key) == self.self_node_id
