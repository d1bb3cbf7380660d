"""Admission plane for the KVCache serving tier.

Two problems with the original per-tier ``asyncio.Semaphore`` windows at
fleet scale:

- **Cross-process over-admission**: admission was per *process*, so a
  host running N client processes admitted N× the intended host-wide
  in-flight bound against the same chains.  With ``scope = "host"`` the
  windows live in a shm token arena (``ShmTokenArena`` riding the
  usrbio slot discipline, t3fs_torch/usrbio/slots.py): every process on the
  host draws namespace and size-class tokens from one pool, and tokens
  held by a crashed process are reclaimed by pid liveness probes.  When
  the arena cannot be created (no /dev/shm, geometry conflict), the
  plane degrades to the per-process fallback and says so in stats.
- **Tenant starvation**: one hot namespace could saturate the whole
  window.  Namespaces now hash onto ``shards`` weighted admission
  shards; a hot tenant saturates its shard's slice of the window, not
  the host.  Per-shard waits/admits/peaks surface in ``stats()`` and
  ``admin kvcache-stats``.

``AdmissionController`` keeps its historical constructor (a private
1-shard process-local plane) so existing call sites and tests are
unchanged; tiers with ``admit_group`` set share one plane per group.

The port of t3fs/kvcache/admission.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import logging
from dataclasses import dataclass

log = logging.getLogger("t3fs_torch.kvcache")

# value-size admission classes: bounds in bytes, names aligned with the
# read path's size classes (t3fs_torch/net/rpcstats.py) so dashboards line up
ADMIT_CLASS_BOUNDS = (4 << 10, 64 << 10)
ADMIT_CLASS_NAMES = ("small", "medium", "large")


@dataclass
class AdmissionConfig:
    window: int = 128                 # per-shard namespace in-flight cap
    class_windows: tuple = (96, 48, 16)
    shards: int = 1
    shard_weights: tuple = ()         # per-shard multipliers; () = all 1.0
    scope: str = "process"            # "process" | "host" (shm arena)
    group: str = ""                   # shared-plane rendezvous name
    poll_interval_s: float = 0.002    # arena-exhausted retry cadence


def _shard_weight(cfg: AdmissionConfig, shard: int) -> float:
    if shard < len(cfg.shard_weights):
        return max(0.0, float(cfg.shard_weights[shard]))
    return 1.0


def _pool_sizes(cfg: AdmissionConfig) -> list[int]:
    """Pool layout: shard-major, [ns, class0, class1, ...] per shard."""
    sizes: list[int] = []
    for s in range(cfg.shards):
        w = _shard_weight(cfg, s)
        sizes.append(max(1, round(cfg.window * w)))
        for cw in cfg.class_windows:
            sizes.append(max(1, round(cw * w)))
    return sizes


class _LocalBackend:
    """Per-process pools: plain asyncio semaphores (the historical
    behavior, and the fallback when the shm arena is unavailable)."""

    def __init__(self, pool_sizes: list[int]):
        self._sems = [asyncio.Semaphore(n) for n in pool_sizes]

    def would_wait(self, pool: int) -> bool:
        return self._sems[pool].locked()

    async def acquire(self, pool: int):
        await self._sems[pool].acquire()
        return None

    def release(self, pool: int, token) -> None:
        self._sems[pool].release()


class _ArenaBackend:
    """Host-wide pools over a ShmTokenArena.  Blocking acquisition is a
    try/sleep poll loop: cross-process wakeups have no shared condvar,
    and the poll interval is far below the IO latencies the windows
    gate."""

    def __init__(self, arena, poll_interval_s: float):
        self.arena = arena
        self.poll = poll_interval_s

    def would_wait(self, pool: int) -> bool:
        return self.arena.used(pool) >= self.arena.pool_size(pool)

    async def acquire(self, pool: int):
        slot = self.arena.try_acquire(pool)
        while slot is None:
            await asyncio.sleep(self.poll)
            slot = self.arena.try_acquire(pool)
        return slot

    def release(self, pool: int, token) -> None:
        self.arena.release(pool, token)


class AdmissionPlane:
    """One host's (or process's) admission token pools, shared by every
    tier bound to the same group.  ``controller(namespace)`` hands out
    the per-tier facade bound to the namespace's shard."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self.arena = None
        self.scope = "process"
        sizes = _pool_sizes(cfg)
        self._pools_per_shard = 1 + len(cfg.class_windows)
        if cfg.scope == "host":
            try:
                from t3fs_torch.usrbio.slots import ShmTokenArena
                self.arena = ShmTokenArena(
                    f"t3fs-admit-{cfg.group or 'default'}", sizes)
                self.backend = _ArenaBackend(self.arena, cfg.poll_interval_s)
                self.scope = "host"
            except Exception as e:
                # per-process fallback: admission still bounds THIS
                # process; the host-wide bound is advisory until the
                # arena comes back
                log.warning("admission arena unavailable (%s); falling "
                            "back to per-process windows", e)
        if self.arena is None:
            self.backend = _LocalBackend(sizes)
        # per-shard counters (this process's view)
        self.shard_stats = [
            {"admitted": 0, "waits": 0, "held": 0, "peak": 0}
            for _ in range(cfg.shards)]

    def shard_of(self, namespace: str) -> int:
        h = int.from_bytes(
            hashlib.blake2b(namespace.encode(), digest_size=8,
                            person=b"t3fs-shd").digest(), "big")
        return h % self.cfg.shards

    def pools_for(self, shard: int) -> tuple[int, list[int]]:
        base = shard * self._pools_per_shard
        return base, list(range(base + 1, base + self._pools_per_shard))

    def controller(self, namespace: str) -> "AdmissionController":
        return AdmissionController.bind(self, namespace)

    def host_peak(self, shard: int = 0) -> int:
        """Host-wide peak concurrent holders of the shard's namespace
        window — exact under scope=host (tracked in the arena header),
        this process's peak otherwise."""
        if self.arena is not None:
            return self.arena.peak(shard * self._pools_per_shard)
        return self.shard_stats[shard]["peak"]

    def reclaim_dead(self) -> int:
        return self.arena.reclaim_dead() if self.arena is not None else 0

    def stats(self) -> dict:
        out = {
            "scope": self.scope,
            "shards": self.cfg.shards,
            "per_shard": [dict(s) for s in self.shard_stats],
        }
        if self.arena is not None:
            out["arena"] = self.arena.stats()
        return out

    def close(self) -> None:
        if self.arena is not None:
            self.arena.close()
            self.arena = None


# shared planes per admit_group, one per process (the arena behind a
# host-scoped group is shared machine-wide by name)
_SHARED_PLANES: dict[str, AdmissionPlane] = {}


def resolve_plane(cfg: AdmissionConfig) -> AdmissionPlane:
    """Group rendezvous: tiers naming the same ``group`` share one
    plane (and its shards); an empty group gets a private plane — the
    historical per-tier behavior."""
    if not cfg.group:
        return AdmissionPlane(cfg)
    key = f"{cfg.scope}:{cfg.group}"
    plane = _SHARED_PLANES.get(key)
    if plane is None:
        plane = _SHARED_PLANES[key] = AdmissionPlane(cfg)
    return plane


class AdmissionController:
    """Per-tier admission facade: a namespace-wide in-flight cap, then a
    per value-size-class cap inside it, drawn from the bound shard of an
    AdmissionPlane.  Acquisition order is fixed (namespace, then class)
    so mixed-size waiters can't deadlock."""

    def __init__(self, window: int, class_windows: tuple):
        self._init(AdmissionPlane(AdmissionConfig(
            window=window, class_windows=tuple(class_windows))), shard=0)

    @classmethod
    def bind(cls, plane: AdmissionPlane,
             namespace: str) -> "AdmissionController":
        self = cls.__new__(cls)
        self._init(plane, plane.shard_of(namespace))
        return self

    def _init(self, plane: AdmissionPlane, shard: int) -> None:
        self.plane = plane
        self.shard = shard
        self._ns_pool, self._cls_pools = plane.pools_for(shard)
        self.waits = 0
        self.held_now = 0
        self.peak_held = 0

    @staticmethod
    def size_class(nbytes: int) -> int:
        return bisect.bisect_right(ADMIT_CLASS_BOUNDS, nbytes)

    def admit(self, nbytes: int) -> "_Admit":
        return _Admit(self, self.size_class(nbytes))

    def stats(self) -> dict:
        return {
            "scope": self.plane.scope,
            "shard": self.shard,
            "waits": self.waits,
            "held_now": self.held_now,
            "peak_held": self.peak_held,
        }


class _Admit:
    def __init__(self, ctl: AdmissionController, cls: int):
        self._ctl = ctl
        self._cls_pool = ctl._cls_pools[cls]
        self._ns_tok = None
        self._cls_tok = None

    async def __aenter__(self):
        ctl = self._ctl
        backend = ctl.plane.backend
        if backend.would_wait(ctl._ns_pool) \
                or backend.would_wait(self._cls_pool):
            ctl.waits += 1
            ctl.plane.shard_stats[ctl.shard]["waits"] += 1
        self._ns_tok = await backend.acquire(ctl._ns_pool)
        try:
            self._cls_tok = await backend.acquire(self._cls_pool)
        except BaseException:
            backend.release(ctl._ns_pool, self._ns_tok)
            raise
        ctl.held_now += 1
        ctl.peak_held = max(ctl.peak_held, ctl.held_now)
        ss = ctl.plane.shard_stats[ctl.shard]
        ss["admitted"] += 1
        ss["held"] += 1
        ss["peak"] = max(ss["peak"], ss["held"])
        return self

    async def __aexit__(self, *exc):
        ctl = self._ctl
        backend = ctl.plane.backend
        backend.release(self._cls_pool, self._cls_tok)
        backend.release(ctl._ns_pool, self._ns_tok)
        ctl.held_now -= 1
        ctl.plane.shard_stats[ctl.shard]["held"] -= 1
        return False
