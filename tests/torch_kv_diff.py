"""Shared pieces of the tests that hold the port's replicated and sharded
KV (t3fs_torch.kv.{service,remote,shard,surgery,distributor}) against the
JAX package's (t3fs.kv): each package's modules by name, KvService nodes
built from either package, the pins that make two runs equal, and the
state dumps the tests compare.  Imported by tests/test_torch_kv_*.py."""

import itertools
import os
import random
import re
import struct
import time
import types as pytypes
import uuid
import zlib

import t3fs.kv.distributor
import t3fs.kv.engine
import t3fs.kv.remote
import t3fs.kv.service
import t3fs.kv.shard
import t3fs.kv.surgery
import t3fs.kv.wal_engine
import t3fs.net.client
import t3fs.net.server
import t3fs.utils.serde
import t3fs.utils.status
import t3fs_torch.kv.distributor
import t3fs_torch.kv.engine
import t3fs_torch.kv.remote
import t3fs_torch.kv.service
import t3fs_torch.kv.shard
import t3fs_torch.kv.surgery
import t3fs_torch.kv.wal_engine
import t3fs_torch.net.client
import t3fs_torch.net.server
import t3fs_torch.utils.serde
import t3fs_torch.utils.status

SEED = 2026
# the fixed time.time() of every pinned run: decision records, freezes and
# load stamps carry it, so the two packages write the same bytes
T0 = 1_700_000_000.0


def _pkg(root) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, engine=root.kv.engine, wal=root.kv.wal_engine,
        service=root.kv.service, remote=root.kv.remote,
        shard=root.kv.shard, surgery=root.kv.surgery,
        dist=root.kv.distributor, client=root.net.client,
        server=root.net.server, serde=root.utils.serde,
        status=root.utils.status)


PKGS = {"ref": _pkg(t3fs), "port": _pkg(t3fs_torch)}


class Clock:
    """time.time() stand-in, still unless advance() moves it."""

    def __init__(self):
        self.now = T0

    def time(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


class Uuids:
    """uuid.uuid4 stand-in: 1, 2, 3, ... as UUIDs."""

    def __init__(self):
        self.n = itertools.count(1)

    def uuid4(self):
        return uuid.UUID(int=next(self.n))


def pin(monkeypatch) -> Clock:
    """Pin what differs between two runs of one sequence: time.time (the
    services import time inside their functions, so the module itself is
    patched), the 2PC txn ids of both packages' shard modules, and the load
    sampler's random stream.  Call it before each package's run."""
    clock = Clock()
    monkeypatch.setattr(time, "time", clock.time)
    ids = Uuids()
    for p in PKGS.values():
        monkeypatch.setattr(p.shard, "uuid", ids)
    random.seed(SEED)
    return clock


class Node:
    """One KvService of package p on its own Server."""

    def __init__(self, p, engine, *, primary=True, ship=None, **kw):
        self.p = p
        self.engine = engine
        self.ship = ship or p.client.Client()
        self.svc = p.service.KvService(engine, primary=primary,
                                       client=self.ship, **kw)
        self.srv = p.server.Server()
        self.srv.add_service(self.svc)

    async def start(self) -> "Node":
        await self.srv.start()
        return self

    @property
    def address(self) -> str:
        return self.srv.address

    async def stop(self) -> None:
        self.svc.stop_decision_gc()
        for entry in list(self.svc._prepared.values()):
            entry[1].cancel()
        await self.srv.stop()
        await self.ship.close()


def wal_engine(p, root: str):
    return p.wal.WalKVEngine(root, sync="os")


def dump_engine(engine) -> list[tuple[bytes, bytes]]:
    """Every key and value the engine holds, internal records included."""
    ver = engine.current_version()
    return [(bytes(k), bytes(v))
            for k, v in engine.range_at(b"", b"\xff" * 18, ver, 0)]


def files(root: str) -> dict[str, bytes]:
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


def wal_frames(root: str) -> dict[str, list[bytes]]:
    """Each WAL or snapshot file of a WAL engine directory as its list of
    frame payloads, every frame's CRC checked against its payload: the
    form to compare where the payloads carry a run's addresses (and so
    their CRCs differ between runs on different ports)."""
    out = {}
    for name, data in files(root).items():
        off = 8 if data[:8] in (b"T3KVWAL1", b"T3KVSNP1") else 0
        frames = [data[:off]]
        while off < len(data):
            plen, crc = struct.unpack_from("<II", data, off)
            payload = data[off + 8:off + 8 + plen]
            assert len(payload) == plen and zlib.crc32(payload) == crc
            frames.append(payload)
            off += 8 + plen
        out[name] = frames
    return out


def code_of(exc) -> int:
    """The StatusCode value an exception carries (0 for none)."""
    code = getattr(exc, "code", None)
    return int(code) if code is not None else -1


class Names:
    """Maps each run's server addresses onto stable group names, so two
    runs on different ports compare equal."""

    def __init__(self):
        self.names: dict[str, str] = {}

    def add(self, address: str, name: str) -> None:
        self.names[address] = name

    def __call__(self, value):
        if isinstance(value, bytes):
            for a, n in self.names.items():
                value = value.replace(a.encode(), n.encode())
            return value
        if isinstance(value, str):
            return re.sub(r"127\.0\.0\.1:\d+",
                          lambda m: self.names.get(m.group(0), m.group(0)),
                          value)
        if isinstance(value, (list, tuple)):
            return type(value)(self(v) for v in value)
        if isinstance(value, dict):
            return {self(k): self(v) for k, v in value.items()}
        return value
