"""Cluster/routing data types.

Reference analogs: fbs/mgmtd/MgmtdTypes.h (PublicTargetState :10,
LocalTargetState :21, strong-typedef ids :55), ChainInfo/ChainTable,
RoutingInfo (fbs/mgmtd/RoutingInfo.h:11-46), HeartbeatInfo.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from t3fs_torch.utils.serde import serde_struct


class PublicTargetState(enum.IntEnum):
    """Target state as published in the chain (MgmtdTypes.h:10)."""
    INVALID = 0
    SERVING = 1       # full chain member, serves reads+writes
    SYNCING = 2       # being brought up to date by predecessor
    WAITING = 3       # offline target waiting to re-join (at chain tail)
    LASTSRV = 4       # last serving target that went offline (still authoritative)
    OFFLINE = 5


class LocalTargetState(enum.IntEnum):
    """Target state as reported by its node in heartbeats (MgmtdTypes.h:21)."""
    INVALID = 0
    UPTODATE = 1
    ONLINE = 2
    OFFLINE = 3


class NodeStatus(enum.IntEnum):
    ACTIVE = 1
    FAILED = 2
    DISABLED = 3


@serde_struct
@dataclass
class ChainTargetInfo:
    target_id: int = 0
    node_id: int = 0
    public_state: PublicTargetState = PublicTargetState.SERVING


@serde_struct
@dataclass
class ChainInfo:
    chain_id: int = 0
    chain_ver: int = 1
    targets: list[ChainTargetInfo] = field(default_factory=list)
    # targets are in chain order: head first; only SERVING targets form the
    # live chain, SYNCING follow, WAITING/OFFLINE tail out (design_notes 201-231)
    # operator-preferred target order (fbs/mgmtd ChainInfo.preferredTargetOrder):
    # rotate_as_preferred_order nudges the chain back toward it one resync
    # cycle at a time; empty = no preference
    preferred_target_order: list[int] = field(default_factory=list)

    def serving(self) -> list[ChainTargetInfo]:
        return [t for t in self.targets if t.public_state == PublicTargetState.SERVING]

    def syncing(self) -> list[ChainTargetInfo]:
        return [t for t in self.targets if t.public_state == PublicTargetState.SYNCING]

    def head(self) -> ChainTargetInfo | None:
        s = self.serving()
        return s[0] if s else None

    def tail(self) -> ChainTargetInfo | None:
        s = self.serving()
        return s[-1] if s else None

    def successor_of(self, target_id: int) -> ChainTargetInfo | None:
        """Next live participant after target_id (serving chain + syncing tail)."""
        live = self.serving() + self.syncing()
        for i, t in enumerate(live):
            if t.target_id == target_id:
                return live[i + 1] if i + 1 < len(live) else None
        return None


@serde_struct
@dataclass
class NodeInfo:
    node_id: int = 0
    address: str = ""            # host:port of the storage/meta service
    node_type: str = "storage"   # storage | meta | mgmtd
    status: NodeStatus = NodeStatus.ACTIVE
    # process generation (start timestamp): lets mgmtd detect a crash-restart
    # that happened WITHIN the heartbeat window — the node looks continuously
    # alive but its serving targets may have lost state and need resync
    generation: float = 0.0
    # operator labels (setNodeTags; placement/ops tooling reads these)
    tags: list = field(default_factory=list)


@serde_struct
@dataclass
class ChainTable:
    """Ordered list of chain ids used for striping layouts
    (fbs/mgmtd/ChainTable.h analog).

    table_ver bumps on every re-install (clients compare it to
    decide whether a table's membership solve moved under them without
    re-reading every chain); table_type mirrors the reference solver's
    -type {CR,EC} split — "cr" replicated chains, "ec" single-replica
    shard chains; replicas persists the DESIRED replication so the
    solver never has to infer it from live chain widths (which are
    transiently R+1 mid-migration).  All serde add-only: pre-15 peers
    leave defaults (replicas=0 = unknown, solver falls back to widths)."""
    table_id: int = 1
    chain_ids: list[int] = field(default_factory=list)
    table_ver: int = 1
    table_type: str = ""
    replicas: int = 0


@serde_struct
@dataclass
class ClientSession:
    """A registered client (FUSE daemon, bench, library user) with a lease
    the MgmtdClientSessionsChecker analog prunes (fbs/mgmtd/ClientSession.h:12,
    mgmtd/background/MgmtdClientSessionsChecker.h)."""
    client_id: str = ""
    universal_id: str = ""       # host identity (survives client restart)
    description: str = ""
    start: float = 0.0
    last_extend: float = 0.0


@serde_struct
@dataclass
class RoutingInfo:
    """The cluster map every client/server caches (RoutingInfo.h:11-46)."""
    version: int = 1
    bootstrapping: bool = False
    nodes: dict[int, NodeInfo] = field(default_factory=dict)
    chains: dict[int, ChainInfo] = field(default_factory=dict)
    chain_tables: dict[int, ChainTable] = field(default_factory=dict)

    def chain(self, chain_id: int) -> ChainInfo | None:
        return self.chains.get(chain_id)

    def node_address(self, node_id: int) -> str | None:
        n = self.nodes.get(node_id)
        return n.address if n else None
