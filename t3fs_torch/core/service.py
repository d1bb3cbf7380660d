"""CoreService: common RPCs hosted by EVERY server binary.

Reference analogs (SURVEY.md §2.1/§5.5-5.6): src/core/ CoreService — config
introspection + hot-update RPCs on every server (src/core/service/ops/:
getConfig / renderConfig / hotUpdateConfig / getLastConfigUpdateRecord),
AppInfo (common/app/ApplicationBase.h:15-72), and the fbs/core user/auth
records (admin tokens persisted in the transactional KV).

Every t3fs server (mgmtd / meta / storage / fuse daemon) registers one
CoreService next to its main service, exactly like the reference registers
CoreService on each net::Server (e.g. storage/service/StorageServer.cc:27-28).

The port of t3fs/core/service.py.
"""

from __future__ import annotations

import os
import secrets
import time
from dataclasses import dataclass, field
from typing import Callable

from t3fs_torch.kv.engine import KVEngine, with_transaction
from t3fs_torch.kv.prefixes import KeyPrefix
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.utils import serde
from t3fs_torch.utils.config import ConfigBase, ConfigError, to_toml
from t3fs_torch.utils.status import StatusCode, make_error

T3FS_VERSION = "0.1.0"


@serde.serde_struct
@dataclass
class AppInfo:
    """Identity of a running server process (ApplicationBase AppInfo analog)."""
    node_id: int = 0
    node_type: str = ""          # mgmtd | meta | storage | fuse | monitor
    address: str = ""
    cluster_id: str = "t3fs"
    pid: int = 0
    start_time: float = 0.0
    version: str = T3FS_VERSION


@serde.serde_struct
@dataclass
class ConfigUpdateRecord:
    ts: float = 0.0
    updated_keys: list[str] = field(default_factory=list)
    ok: bool = True
    message: str = ""


@serde.serde_struct
@dataclass
class RpcStatsRsp:
    stats_json: str = ""       # rpcstats snapshot(), JSON-encoded


@serde.serde_struct
@dataclass
class EchoReq:
    message: str = ""


@serde.serde_struct
@dataclass
class EchoRsp:
    message: str = ""


@serde.serde_struct
@dataclass
class GetConfigReq:
    pass


@serde.serde_struct
@dataclass
class GetConfigRsp:
    toml: str = ""


@serde.serde_struct
@dataclass
class RenderConfigReq:
    """Dry-run: render config with overrides applied, without committing
    (reference: RenderConfig / VerifyConfig admin flow)."""
    overrides: dict[str, object] = field(default_factory=dict)
    hot_only: bool = True
    admin_token: str = ""


@serde.serde_struct
@dataclass
class RenderConfigRsp:
    toml: str = ""
    updated_keys: list[str] = field(default_factory=list)


@serde.serde_struct
@dataclass
class HotUpdateConfigReq:
    overrides: dict[str, object] = field(default_factory=dict)
    admin_token: str = ""


@serde.serde_struct
@dataclass
class HotUpdateConfigRsp:
    updated_keys: list[str] = field(default_factory=list)


@serde.serde_struct
@dataclass
class GetAppInfoRsp:
    info: AppInfo = field(default_factory=AppInfo)
    uptime_s: float = 0.0


@serde.serde_struct
@dataclass
class LastConfigUpdateRsp:
    record: ConfigUpdateRecord | None = None


# ---- user / auth (fbs/core user ctrl analog) ----

@serde.serde_struct
@dataclass
class UserInfo:
    uid: int = 0
    name: str = ""
    token: str = ""
    is_admin: bool = False
    gids: list[int] = field(default_factory=list)


@serde.serde_struct
@dataclass
class UserReq:
    admin_token: str = ""
    user: UserInfo = field(default_factory=UserInfo)


@serde.serde_struct
@dataclass
class UserRsp:
    users: list[UserInfo] = field(default_factory=list)


def _user_key(uid: int) -> bytes:
    if not 0 <= uid < 2 ** 64:
        raise make_error(StatusCode.INVALID_ARG, f"uid out of range: {uid}")
    # big-endian so the uid keyspace sorts correctly under the range scan
    return KeyPrefix.USER.key(uid.to_bytes(8, "big"))


def _user_range() -> tuple[bytes, bytes]:
    """[prefix, prefix+1): covers ALL uid encodings — prefix+b'\\xff' would
    exclude any key whose first suffix byte is 0xff."""
    lo = KeyPrefix.USER.value
    return lo, lo[:-1] + bytes([lo[-1] + 1])


@service("Core")
class CoreService:
    """getConfig / renderConfig / hotUpdateConfig / echo / appInfo / users."""

    def __init__(self, app_info: AppInfo, config: ConfigBase | None = None,
                 kv: KVEngine | None = None,
                 on_config_updated: Callable[[list[str]], None] | None = None,
                 admin_token: str = ""):
        app_info.pid = app_info.pid or os.getpid()
        app_info.start_time = app_info.start_time or time.time()
        self.app_info = app_info
        self.config = config
        self.kv = kv
        self.on_config_updated = on_config_updated
        self.admin_token = admin_token
        self.last_update: ConfigUpdateRecord | None = None

    @rpc_method
    async def echo(self, req: EchoReq, payload, conn):
        return EchoRsp(req.message), payload

    @rpc_method
    async def getAppInfo(self, req, payload, conn):
        return GetAppInfoRsp(self.app_info,
                             time.time() - self.app_info.start_time), b""

    @rpc_method
    async def getRpcStats(self, req, payload, conn):
        """This process's RPC latency decomposition (queue/server/
        network split per method; t3fs_torch/net/rpcstats.py) — the live
        counterpart of the T3FS_RPC_STATS file dump, so `rpc-top --live`
        can ask any node where its RPCs spend their time (reference
        carries 8 wire timestamps for exactly this,
        serde/MessagePacket.h:43-50)."""
        import json as _json

        from t3fs_torch.net.rpcstats import RPC_STATS
        return RpcStatsRsp(stats_json=_json.dumps(RPC_STATS.snapshot())), b""

    @rpc_method
    async def getConfig(self, req: GetConfigReq, payload, conn):
        if self.config is None:
            return GetConfigRsp(""), b""
        return GetConfigRsp(to_toml(self.config.to_dict())), b""

    @rpc_method
    async def renderConfig(self, req: RenderConfigReq, payload, conn):
        self._check_admin_if_configured(req.admin_token)
        if self.config is None:
            raise make_error(StatusCode.INVALID_ARG, "server has no config object")
        shadow = type(self.config).from_dict(self.config.to_dict())
        try:
            keys = shadow.update(dict(req.overrides), hot_only=req.hot_only)
        except ConfigError as e:
            raise make_error(StatusCode.INVALID_ARG, str(e)) from None
        return RenderConfigRsp(to_toml(shadow.to_dict()), keys), b""

    @rpc_method
    async def hotUpdateConfig(self, req: HotUpdateConfigReq, payload, conn):
        self._check_admin_if_configured(req.admin_token)
        if self.config is None:
            raise make_error(StatusCode.INVALID_ARG, "server has no config object")
        try:
            keys = self.config.update(dict(req.overrides), hot_only=True)
        except ConfigError as e:
            self.last_update = ConfigUpdateRecord(time.time(), [], False, str(e))
            raise make_error(StatusCode.INVALID_ARG, str(e)) from None
        self.last_update = ConfigUpdateRecord(time.time(), keys, True, "")
        if keys and self.on_config_updated is not None:
            self.on_config_updated(keys)
        return HotUpdateConfigRsp(keys), b""

    @rpc_method
    async def getLastConfigUpdateRecord(self, req, payload, conn):
        return LastConfigUpdateRsp(self.last_update), b""

    # ---- user ctrl ----

    def _check_admin(self, token: str) -> None:
        if not self.admin_token or not secrets.compare_digest(token, self.admin_token):
            raise make_error(StatusCode.AUTH_FAILED, "bad admin token")

    def _check_admin_if_configured(self, token: str) -> None:
        """Config mutation needs the admin token when one is set; a server
        launched without a token (dev/test fixtures) stays open."""
        if self.admin_token:
            self._check_admin(token)

    def _need_kv(self) -> KVEngine:
        if self.kv is None:
            raise make_error(StatusCode.INVALID_ARG, "server has no user store")
        return self.kv

    @rpc_method
    async def userAdd(self, req: UserReq, payload, conn):
        self._check_admin(req.admin_token)
        kv = self._need_kv()
        user = req.user
        if not user.token:
            user.token = secrets.token_hex(16)

        async def op(txn):
            txn.set(_user_key(user.uid), serde.dumps(user))
        await with_transaction(kv, op)
        return UserRsp([user]), b""

    @rpc_method
    async def userGet(self, req: UserReq, payload, conn):
        kv = self._need_kv()

        async def op(txn):
            return await txn.get(_user_key(req.user.uid))
        raw = await with_transaction(kv, op)
        if raw is None:
            raise make_error(StatusCode.NOT_FOUND, f"no user {req.user.uid}")
        user: UserInfo = serde.loads(raw)
        is_admin = bool(self.admin_token) and secrets.compare_digest(
            req.admin_token, self.admin_token)
        if not is_admin and not secrets.compare_digest(req.user.token, user.token):
            # without the admin token or the user's own token, never
            # reveal the stored credential
            user.token = ""
        return UserRsp([user]), b""

    @rpc_method
    async def userList(self, req: UserReq, payload, conn):
        self._check_admin(req.admin_token)
        kv = self._need_kv()

        async def op(txn):
            lo, hi = _user_range()
            return await txn.get_range(lo, hi)
        rows = await with_transaction(kv, op)
        return UserRsp([serde.loads(v) for _, v in rows]), b""

    @rpc_method
    async def userRemove(self, req: UserReq, payload, conn):
        self._check_admin(req.admin_token)
        kv = self._need_kv()

        async def op(txn):
            txn.clear(_user_key(req.user.uid))
        await with_transaction(kv, op)
        return UserRsp([]), b""
