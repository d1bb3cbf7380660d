"""Per-user FUSE config + the /t3fs-virt magic tree.

Reference analog: src/fuse/UserConfig.{h,cc} (per-uid config overrides with
system/user key split) and FuseOps.cc:352-400,654-696 — a virtual directory
`/3fs-virt` exposing:

- ``get-conf/<key>``   symlink whose target is the calling uid's effective
                       value (``readlink`` = config read)
- ``set-conf/<key>``   created BY symlink: ``ln -s <value> set-conf/<key>``
                       sets the override for the calling uid
- ``rm-rf/<name>``     ``ln -s <abs-path-in-mount> rm-rf/x`` performs a
                       recursive server-side remove without per-entry
                       round trips (reference rm-rf dir)

The reference also mounts an ``iovs`` registration dir for USRBIO shared
memory; t3fs registers rings through the ring-worker's shm directory
(t3fs_torch/fuse/ring_worker.py) instead, so no iovs virtual dir is needed.

Virtual inode ids live at VIRT_BASE = 1<<48, far above meta's sequential
allocation.

The port of t3fs/fuse/user_config.py, a copy on the port's meta.schema.
"""

from __future__ import annotations

import errno
import time
from dataclasses import dataclass, fields, replace

from t3fs_torch.meta.schema import Inode, InodeType, ROOT_INODE_ID

VIRT_BASE = 1 << 48
VIRT_DIR = VIRT_BASE + 1
RMRF_DIR = VIRT_BASE + 2
GETCONF_DIR = VIRT_BASE + 3
SETCONF_DIR = VIRT_BASE + 4
KEY_BASE = VIRT_BASE + 16          # + key index (get-conf); +64 for set-conf
SETKEY_BASE = VIRT_BASE + 64

VIRT_NAME = "t3fs-virt"


@dataclass
class MountUserConfig:
    """Per-uid effective knobs (reference FuseConfig user keys,
    UserConfig.h:33-39 — trimmed to what t3fs's mount honors)."""
    readonly: bool = False
    attr_timeout: float = 1.0      # kernel attr cache validity (s)
    entry_timeout: float = 1.0     # kernel dentry cache validity (s)
    sync_on_stat: bool = False     # GETATTR settles precise length first


USER_KEYS = [f.name for f in fields(MountUserConfig)]


MAX_TIMEOUT_S = 3600.0


def _parse(key: str, val: str):
    cur = getattr(MountUserConfig(), key)
    if isinstance(cur, bool):
        if val.lower() in ("1", "true", "yes", "on"):
            return True
        if val.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(val)
    parsed = type(cur)(val)
    if isinstance(parsed, float):
        # a negative or absurd timeout would make the fuse_entry_out pack
        # raise on every subsequent request — reject at the write
        if not (0.0 <= parsed <= MAX_TIMEOUT_S):
            raise ValueError(f"{key} out of range [0, {MAX_TIMEOUT_S}]")
    return parsed


class UserConfig:
    """Mount-wide defaults + per-uid overrides (UserConfig.h:9-17).
    uid 0 writes through set-conf update the mount default (system scope);
    other uids shadow it for themselves only."""

    def __init__(self, base: MountUserConfig | None = None):
        self.base = base or MountUserConfig()
        self._per_uid: dict[int, dict[str, object]] = {}

    def get(self, uid: int) -> MountUserConfig:
        over = self._per_uid.get(uid)
        return replace(self.base, **over) if over else self.base

    def set_key(self, uid: int, key: str, val: str) -> None:
        if key not in USER_KEYS:
            raise KeyError(key)
        parsed = _parse(key, val)
        if uid == 0:
            setattr(self.base, key, parsed)
        else:
            self._per_uid.setdefault(uid, {})[key] = parsed

    def value_str(self, uid: int, key: str) -> str:
        v = getattr(self.get(uid), key)
        return str(int(v)) if isinstance(v, bool) else str(v)


def _vdir(inode_id: int, perm: int = 0o555) -> Inode:
    ino = Inode(inode_id=inode_id, itype=InodeType.DIRECTORY, perm=perm,
                nlink=2, parent=VIRT_DIR if inode_id != VIRT_DIR
                else ROOT_INODE_ID)
    ino.mtime = ino.ctime = ino.atime = time.time()
    return ino


class VirtualTree:
    """Opcode interceptor for the magic tree.  ``handle`` returns an
    awaitable-result or raises; returns NotImplemented when the request is
    not virtual so the normal path runs."""

    def __init__(self, user_config: UserConfig, remove_tree):
        self.cfg = user_config
        self._remove_tree = remove_tree      # async (path, uid) -> None
        self._dirs = {
            VIRT_DIR: _vdir(VIRT_DIR),
            RMRF_DIR: _vdir(RMRF_DIR, 0o777),
            GETCONF_DIR: _vdir(GETCONF_DIR),
            SETCONF_DIR: _vdir(SETCONF_DIR, 0o777),
        }
        self._names = {VIRT_DIR: VIRT_NAME, RMRF_DIR: "rm-rf",
                       GETCONF_DIR: "get-conf", SETCONF_DIR: "set-conf"}

    def is_virtual(self, nodeid: int) -> bool:
        return nodeid >= VIRT_BASE

    # -- inode builders --

    def _key_symlink(self, idx: int, uid: int, set_side: bool) -> Inode:
        key = USER_KEYS[idx]
        ino = Inode(inode_id=(SETKEY_BASE if set_side else KEY_BASE) + idx,
                    itype=InodeType.SYMLINK,
                    symlink_target=self.cfg.value_str(uid, key))
        ino.mtime = ino.ctime = ino.atime = time.time()
        return ino

    def lookup(self, parent: int, name: str, uid: int) -> Inode | None:
        """Virtual LOOKUP; None = ENOENT within the tree."""
        if parent == ROOT_INODE_ID and name == VIRT_NAME:
            return self._dirs[VIRT_DIR]
        if parent == VIRT_DIR:
            for iid, n in self._names.items():
                if n == name and iid != VIRT_DIR:
                    return self._dirs[iid]
            return None
        if parent == GETCONF_DIR:
            if name in USER_KEYS:
                return self._key_symlink(USER_KEYS.index(name), uid, False)
            return None
        if parent in (SETCONF_DIR, RMRF_DIR):
            # write-only mailboxes: symlink(2) LOOKUPs the name first and
            # would fail EEXIST if we answered; values are read via get-conf
            return None
        raise OSError(errno.ENOENT, "no such virtual node")

    def getattr(self, nodeid: int, uid: int) -> Inode:
        if nodeid in self._dirs:
            return self._dirs[nodeid]
        if KEY_BASE <= nodeid < KEY_BASE + len(USER_KEYS):
            return self._key_symlink(nodeid - KEY_BASE, uid, False)
        if SETKEY_BASE <= nodeid < SETKEY_BASE + len(USER_KEYS):
            return self._key_symlink(nodeid - SETKEY_BASE, uid, True)
        raise OSError(errno.ENOENT, "no such virtual node")

    def readlink(self, nodeid: int, uid: int) -> str:
        return self.getattr(nodeid, uid).symlink_target

    def listing(self, nodeid: int, uid: int) -> list[tuple[int, str, InodeType]]:
        out = [(nodeid, ".", InodeType.DIRECTORY),
               (ROOT_INODE_ID if nodeid == VIRT_DIR else VIRT_DIR, "..",
                InodeType.DIRECTORY)]
        if nodeid == VIRT_DIR:
            out += [(iid, n, InodeType.DIRECTORY)
                    for iid, n in self._names.items() if iid != VIRT_DIR]
        elif nodeid == GETCONF_DIR:
            out += [(KEY_BASE + i, k, InodeType.SYMLINK)
                    for i, k in enumerate(USER_KEYS)]
        elif nodeid not in (RMRF_DIR, SETCONF_DIR):   # mailboxes list empty
            raise OSError(errno.ENOTDIR, "not a virtual dir")
        return out

    async def symlink(self, parent: int, name: str, target: str,
                      uid: int) -> Inode:
        if parent == SETCONF_DIR:
            # `ln -s <value> set-conf/<key>`
            try:
                self.cfg.set_key(uid, name, target)
            except KeyError:
                raise OSError(errno.ENOENT, f"unknown config key {name}")
            except ValueError:
                raise OSError(errno.EINVAL, f"bad value for {name}")
            return self._key_symlink(USER_KEYS.index(name), uid, True)
        if parent == RMRF_DIR:
            # `ln -s /path/in/mount rm-rf/<anything>`
            await self._remove_tree(target, uid)
            ino = Inode(inode_id=RMRF_DIR + 100, itype=InodeType.SYMLINK,
                        symlink_target=target)
            ino.mtime = ino.ctime = ino.atime = time.time()
            return ino
        raise OSError(errno.EACCES, "read-only virtual dir")
