"""Status/Result error model.

Mirrors the reference's Result<T>/Status (src/common/utils/Result.h): every
RPC response and storage IOResult carries a status code rather than raising
across the wire.  In-process, Python exceptions (StatusError) carry the same
Status so services convert at the boundary.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class StatusCode(enum.IntEnum):
    OK = 0

    # generic
    INVALID_ARG = 2001
    NOT_FOUND = 2002
    TIMEOUT = 2003
    NOT_IMPLEMENTED = 2004
    INTERNAL = 2005
    CANCELLED = 2006
    BUSY = 2007
    AUTH_FAILED = 2008

    # net/rpc (reference: RPCCode)
    RPC_SEND_FAILED = 3001
    RPC_TIMEOUT = 3002
    RPC_CONNECT_FAILED = 3003
    RPC_BAD_MESSAGE = 3004
    RPC_METHOD_NOT_FOUND = 3005
    STALE_RKEY = 3006                # one-sided op with a dead capability:
                                     # the registration behind the handle's
                                     # rkey token is gone (re-registered /
                                     # re-attached session); fail closed

    # kv/transaction (reference: TransactionCode)
    TXN_CONFLICT = 4001
    TXN_TOO_OLD = 4002
    TXN_MAYBE_COMMITTED = 4003
    TXN_RETRYABLE = 4004

    # storage (reference: StorageCode/StorageClientCode)
    CHUNK_NOT_FOUND = 5001
    CHUNK_STALE_UPDATE = 5002        # updateVer <= committed (retry of applied write)
    CHUNK_MISSING_UPDATE = 5003      # updateVer gap (earlier update lost)
    CHUNK_BUSY = 5004                # pending update in flight
    CHUNK_ADVANCE_UPDATE = 5005      # update beyond pending+1
    CHUNK_NOT_COMMIT = 5006          # read of uncommitted chunk
    CHECKSUM_MISMATCH = 5007
    CHAIN_VERSION_MISMATCH = 5008
    TARGET_NOT_FOUND = 5009
    TARGET_OFFLINE = 5010
    NOT_HEAD = 5011                  # write sent to non-head target
    NO_SPACE = 5012
    TARGET_SYNCING = 5013            # full-chunk-replace required
    READ_ONLY = 5014
    EC_FORMAT_MISMATCH = 5015        # stripe parity written with another generator
    DISK_ERROR = 5016                # target disk I/O failure (going OFFLINE)

    # meta (reference: MetaCode)
    META_NOT_FOUND = 6001
    META_EXISTS = 6002
    META_NOT_DIR = 6003
    META_IS_DIR = 6004
    META_NOT_EMPTY = 6005
    META_TOO_MANY_SYMLINKS = 6006
    META_NO_PERMISSION = 6007
    META_BUSY = 6008
    META_INVALID_PATH = 6009
    META_DIR_LOCKED = 6010

    # kv service (FoundationDB/CustomKvEngine role)
    KV_NOT_PRIMARY = 7101
    KV_REPLICA_GAP = 7102
    KV_REPLICATION_FAILED = 7103
    KV_TXN_NOT_FOUND = 7104      # 2PC: prepared txn expired/unknown here
    KV_WRONG_SHARD = 7105        # key outside this group's owned ranges
    KV_SHARD_FROZEN = 7106       # range frozen for an in-flight move

    # mgmtd (reference: MgmtdCode)
    MGMTD_NOT_PRIMARY = 7001
    MGMTD_STALE_ROUTING = 7002
    MGMTD_HEARTBEAT_VERSION_STALE = 7003
    MGMTD_LEASE_EXPIRED = 7004


# codes a client may retry against the same or another target
RETRYABLE_CODES = frozenset({
    StatusCode.TIMEOUT, StatusCode.BUSY,
    StatusCode.RPC_SEND_FAILED, StatusCode.RPC_TIMEOUT,
    StatusCode.RPC_CONNECT_FAILED,
    StatusCode.TXN_CONFLICT, StatusCode.TXN_TOO_OLD, StatusCode.TXN_RETRYABLE,
    StatusCode.CHUNK_BUSY, StatusCode.CHAIN_VERSION_MISMATCH,
    StatusCode.TARGET_OFFLINE, StatusCode.NOT_HEAD, StatusCode.TARGET_SYNCING,
    # the target just offlined itself; mgmtd will reshape the chain shortly
    StatusCode.DISK_ERROR,
    # routing staleness: the chain/target may simply not have propagated yet
    StatusCode.TARGET_NOT_FOUND,
    StatusCode.MGMTD_NOT_PRIMARY, StatusCode.MGMTD_STALE_ROUTING,
    # client probes the address list for the current primary
    StatusCode.KV_NOT_PRIMARY,
})


@dataclass(frozen=True)
class Status:
    code: StatusCode = StatusCode.OK
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.code == StatusCode.OK

    @property
    def retryable(self) -> bool:
        return self.code in RETRYABLE_CODES

    def raise_if_error(self) -> "Status":
        if not self.ok:
            raise StatusError(self.code, self.message)
        return self

    def __str__(self) -> str:
        return f"{self.code.name}({self.code.value}): {self.message}" if not self.ok else "OK"


OK = Status()


class StatusError(Exception):
    """Exception form of a non-OK Status."""

    def __init__(self, code: StatusCode, message: str = ""):
        super().__init__(f"{StatusCode(code).name}: {message}")
        self.status = Status(StatusCode(code), message)

    @property
    def code(self) -> StatusCode:
        return self.status.code


def make_error(code: StatusCode, message: str = "") -> StatusError:
    return StatusError(code, message)
