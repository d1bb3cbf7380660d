"""Token authentication for meta RPC identities.

Reference analog: the flat::UserInfo + token flow — every RPC carries the
caller's identity, and the server trusts the USER REGISTRY's record, not
the claim (src/fbs/core/user/User.h, core user store).  t3fs's registry
is the CoreService user store (admin user-add / userGet,
t3fs/core/service.py:241-269); this module verifies a claimed UserInfo's
token against it and returns the REGISTERED record, so a forged uid or
gids list in the claim cannot escalate.

Deployments without a registry run unauthenticated (authenticator=None on
MetaService): identities are trusted as claimed — the NFS AUTH_SYS model,
appropriate inside a closed cluster network.

The port of t3fs/meta/auth.py.
"""

from __future__ import annotations

import secrets

from t3fs_torch.core.service import UserInfo, _user_key
from t3fs_torch.kv.engine import KVEngine, with_transaction
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode, make_error


def make_token_authenticator(kv: KVEngine, cache_ttl_s: float = 10.0,
                             cache_capacity: int = 4096):
    """(claimed UserInfo) -> verified UserInfo from the registry; raises
    META_NO_PERMISSION for unknown uids or token mismatches.  Pass the
    result as MetaService(authenticator=...).

    Successful verifications memoize for cache_ttl_s (the AclCache role,
    src/meta/components/AclCache.h:16): authentication sits on EVERY meta
    RPC, and a registry transaction per stat/lookup would multiply hot-
    path latency.  The TTL bounds how long a revoked/rotated token keeps
    working; failures are never cached (a just-added user works at once).
    """
    from t3fs_torch.utils.lock_manager import ExpiringMap

    cache: ExpiringMap = ExpiringMap(ttl_s=cache_ttl_s,
                                     capacity=cache_capacity,
                                     touch_on_get=False)

    async def authenticate(claimed: UserInfo) -> UserInfo:
        key = (claimed.uid, claimed.token or "")
        hit = cache.get(key)
        if hit is not None:
            return hit

        async def op(txn):
            return await txn.get(_user_key(claimed.uid))
        raw = await with_transaction(kv, op)
        if raw is None:
            raise make_error(StatusCode.META_NO_PERMISSION,
                             f"uid {claimed.uid}: not in the user registry")
        rec: UserInfo = serde.loads(raw)
        if not rec.token or not secrets.compare_digest(
                claimed.token or "", rec.token):
            raise make_error(StatusCode.META_NO_PERMISSION,
                             f"uid {claimed.uid}: bad token")
        cache.set(key, rec)
        return rec

    return authenticate
