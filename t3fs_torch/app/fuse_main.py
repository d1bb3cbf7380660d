"""fuse_main: mount a t3fs cluster via the kernel FUSE bridge.

Reference analog: src/fuse/hf3fs_fuse.cpp + FuseMainLoop (the
hf3fs_fuse_main binary).  Discovers meta servers from mgmtd routing,
registers a client session, and serves /dev/fuse until SIGINT/SIGTERM.

    python -m t3fs_torch.app.fuse_main --config fuse.toml
    # or: python -m t3fs_torch.app.fuse_main --set mgmtd_address=... --set mountpoint=/mnt/t3fs

The port of t3fs/app/fuse_main.py, a copy on the port's app.base, clients
and utils.config.  A client process: it builds no codec and does no device
work, so it runs without a GPU, as the reference's does.
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass

from t3fs_torch.app.base import ApplicationBase, LogConfig
from t3fs_torch.client.meta_client import MetaClient
from t3fs_torch.client.mgmtd_client import MgmtdClient
from t3fs_torch.client.storage_client import (
    StorageClient, StorageClientConfig, TargetSelection,
)
from t3fs_torch.fuse.kernel import FuseKernelMount
from t3fs_torch.utils.config import ConfigBase, cchoice, citem, cobj


@dataclass
class StorageTuning(ConfigBase):
    """[storage] section: the mount's read-path policy (all hot-updatable).

    read_selection picks the replica policy per read; "adaptive" weighs
    in-flight RPCs and observed p50 per address.  read_hedging re-issues
    IOs still pending past the primary's tracked p9x (clamped to
    [floor, cap] ms) to a different replica, bounded by the token-bucket
    budget (pct of reads + burst) — "off" is byte-for-byte the plain path.
    """
    read_selection: str = citem(
        "load_balance",
        validator=cchoice("load_balance", "round_robin", "head", "tail",
                          "adaptive"))
    read_hedging: str = citem("off", validator=cchoice("off", "on"))
    hedge_delay_floor_ms: float = citem(2.0, validator=lambda v: v >= 0)
    hedge_delay_cap_ms: float = citem(500.0, validator=lambda v: v >= 0)
    hedge_budget_pct: float = citem(0.05, validator=lambda v: 0 <= v <= 1)
    hedge_budget_burst: int = citem(8, validator=lambda v: v >= 0)

    _SELECTION = {"load_balance": TargetSelection.LOAD_BALANCE,
                  "round_robin": TargetSelection.ROUND_ROBIN,
                  "head": TargetSelection.HEAD_TARGET,
                  "tail": TargetSelection.TAIL_TARGET,
                  "adaptive": TargetSelection.ADAPTIVE}

    def client_config(self) -> StorageClientConfig:
        return StorageClientConfig(
            read_selection=self._SELECTION[self.read_selection],
            read_hedging=self.read_hedging,
            hedge_delay_floor_s=self.hedge_delay_floor_ms / 1e3,
            hedge_delay_cap_s=self.hedge_delay_cap_ms / 1e3,
            hedge_budget_pct=self.hedge_budget_pct,
            hedge_budget_burst=self.hedge_budget_burst)


@dataclass
class FuseMainConfig(ConfigBase):
    mgmtd_address: str = citem("127.0.0.1:9000", hot=False)
    mountpoint: str = citem("", hot=False)
    client_id: str = citem("", hot=False)      # default: random per mount
    max_write: int = citem(1 << 17, hot=False, validator=lambda v: v >= 4096)
    # mount-wide user-config defaults; per-uid overrides happen live via
    # /t3fs-virt/set-conf (src/fuse/UserConfig analog)
    readonly: bool = citem(False, hot=False)
    # same [0, 3600] bound the set-conf write path enforces: a negative or
    # absurd timeout would make every fuse_entry_out pack raise (EIO mount)
    attr_timeout: float = citem(1.0, hot=False,
                                validator=lambda v: 0 <= v <= 3600)
    entry_timeout: float = citem(1.0, hot=False,
                                 validator=lambda v: 0 <= v <= 3600)
    sync_on_stat: bool = citem(False, hot=False)
    # supplementary-group resolution for mode-bit checks (the FUSE header
    # carries only the primary gid): "registry" = the mgmtd CoreService
    # user store (cluster identity authority), "host" = the mount host's
    # /etc/group via getgrouplist(3), "none" = primary gid only
    group_source: str = citem(
        "registry", hot=False,
        validator=lambda v: v in ("registry", "host", "none"))
    storage: StorageTuning = cobj(StorageTuning)
    log: LogConfig = cobj(LogConfig)


async def serve(cfg: FuseMainConfig, app: ApplicationBase) -> None:
    assert cfg.mountpoint, "mountpoint is required"
    client_id = cfg.client_id or f"fuse-{uuid.uuid4().hex[:10]}"
    mgmtd = MgmtdClient(cfg.mgmtd_address, client_id=client_id,
                        description=f"fuse mount {cfg.mountpoint}")
    state: dict = {}

    async def start():
        await mgmtd.start()
        meta_addrs = [n.address for n in mgmtd.routing().nodes.values()
                      if n.node_type == "meta" and n.address]
        if not meta_addrs:
            raise RuntimeError("no meta servers in routing; is meta up?")
        mc = MetaClient(meta_addrs, client_id=client_id)
        sc = StorageClient(mgmtd.routing, config=cfg.storage.client_config(),
                           refresh_routing=mgmtd.refresh)
        from t3fs_torch.fuse.user_config import MountUserConfig
        resolver = None
        if cfg.group_source == "registry":
            from t3fs_torch.fuse.kernel import registry_group_resolver
            # the user registry rides the mgmtd node's CoreService
            resolver = registry_group_resolver(cfg.mgmtd_address,
                                               mgmtd.client)
        elif cfg.group_source == "host":
            from t3fs_torch.fuse.kernel import host_group_resolver
            resolver = host_group_resolver()
        fuse = FuseKernelMount(mc, sc, cfg.mountpoint, client_id=client_id,
                               max_write=cfg.max_write,
                               group_resolver=resolver,
                               user_config=MountUserConfig(
                                   readonly=cfg.readonly,
                                   attr_timeout=cfg.attr_timeout,
                                   entry_timeout=cfg.entry_timeout,
                                   sync_on_stat=cfg.sync_on_stat))
        await fuse.mount()
        state.update(mc=mc, sc=sc, fuse=fuse)

    async def stop():
        if "fuse" in state:
            await state["fuse"].unmount()
        if "sc" in state:
            await state["sc"].close()
        if "mc" in state:
            await state["mc"].close_conn()
        await mgmtd.stop()

    await app.run(start, stop)


def main(argv: list[str] | None = None) -> None:
    app = ApplicationBase("fuse", FuseMainConfig)
    cfg = app.boot(argv)
    asyncio.run(serve(cfg, app))


if __name__ == "__main__":
    main()
