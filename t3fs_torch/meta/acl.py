"""POSIX permission checks for meta ops.

Reference analog: `inode.acl.checkPermission(user, AccessType)` called in
every meta op (src/meta/store/ops/SetAttr.h:76,99) with authenticated
`UserInfo` on each RPC, memoized by AclCache
(src/meta/components/AclCache.h:16).  t3fs keeps the checks pure
functions over the inode's (perm, uid, gid) triple; the store calls them
wherever the reference consults the ACL.

`user=None` means a TRUSTED caller (internal subsystems, admin tooling,
tests) and bypasses enforcement — the service layer decides whether a
request carries an identity, the store just enforces whatever it is
given.  uid 0 (and is_admin identities from the user registry) is root
and bypasses mode bits (but NOT the explicit ownership rules for chown).

The identity type is the SAME UserInfo the core user registry stores and
authenticates (t3fs/core/service.py:125) — one identity flows from
`admin user-add` through RPC to the mode-bit check, mirroring the
reference's single UserInfo through flat::UserInfo on every call.

The port of t3fs/meta/acl.py.
"""

from __future__ import annotations

from t3fs_torch.core.service import UserInfo
from t3fs_torch.utils.status import StatusCode, make_error

__all__ = ["UserInfo", "R", "W", "X", "S_ISVTX", "may", "check",
           "check_sticky", "check_owner", "check_chown", "is_root",
           "in_group", "primary_gid"]

# access bits (classic rwx)
R, W, X = 4, 2, 1

S_ISVTX = 0o1000   # sticky: restricted deletion on directories


def is_root(user: UserInfo) -> bool:
    return user.uid == 0 or user.is_admin


def in_group(user: UserInfo, gid: int) -> bool:
    return gid in user.gids


def primary_gid(user: UserInfo) -> int:
    """New inodes take the identity's first registered group."""
    return user.gids[0] if user.gids else 0


def may(inode, user: UserInfo | None, access: int) -> bool:
    """Mode-bit check: owner/group/other triad selected by uid/gids."""
    if user is None or is_root(user):
        return True
    mode = inode.perm
    if user.uid == inode.uid:
        bits = (mode >> 6) & 7
    elif in_group(user, inode.gid):
        bits = (mode >> 3) & 7
    else:
        bits = mode & 7
    return (bits & access) == access


_NAMES = {R: "read", W: "write", X: "execute/search",
          R | W: "read/write", W | X: "write/search", R | X: "read/search"}


def check(inode, user: UserInfo | None, access: int, path: str = "") -> None:
    """Raise META_NO_PERMISSION (-> EACCES on FUSE) unless allowed."""
    if not may(inode, user, access):
        raise make_error(
            StatusCode.META_NO_PERMISSION,
            f"{path or inode.inode_id}: uid {user.uid} denied "
            f"{_NAMES.get(access, access)} (mode {inode.perm:04o} "
            f"owner {inode.uid}:{inode.gid})")


def check_sticky(parent, entry_inode, user: UserInfo | None,
                 path: str = "") -> None:
    """Restricted deletion: in a sticky directory only the entry's owner,
    the directory's owner, or root may remove/rename the entry."""
    if user is None or is_root(user):
        return
    if not (parent.perm & S_ISVTX):
        return
    if user.uid in (entry_inode.uid, parent.uid):
        return
    raise make_error(
        StatusCode.META_NO_PERMISSION,
        f"{path}: sticky directory — uid {user.uid} owns neither the "
        f"entry (uid {entry_inode.uid}) nor the directory "
        f"(uid {parent.uid})")


def check_owner(inode, user: UserInfo | None, what: str,
                path: str = "") -> None:
    """Ops reserved for the owner (chmod, explicit utimes)."""
    if user is None or is_root(user) or user.uid == inode.uid:
        return
    raise make_error(
        StatusCode.META_NO_PERMISSION,
        f"{path or inode.inode_id}: {what} requires ownership "
        f"(owner uid {inode.uid}, caller uid {user.uid})")


def check_chown(inode, user: UserInfo | None, new_uid: int | None,
                new_gid: int | None, path: str = "") -> None:
    """chown(2) rules: only root may change uid; the owner may change gid
    to any group they belong to."""
    if user is None or is_root(user):
        return
    if new_uid is not None and new_uid != inode.uid:
        raise make_error(
            StatusCode.META_NO_PERMISSION,
            f"{path or inode.inode_id}: only root may change the owner")
    if new_gid is not None and new_gid != inode.gid:
        if user.uid != inode.uid or not in_group(user, new_gid):
            raise make_error(
                StatusCode.META_NO_PERMISSION,
                f"{path or inode.inode_id}: gid {new_gid} change denied "
                f"(owner-only, and only into the caller's own groups)")
