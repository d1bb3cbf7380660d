"""The port's metadata plane against the JAX package's, bit for bit: the
meta structs' serde bytes, a seeded namespace sequence through each
package's MetaStore (every op's result or StatusCode, then every KV key
and value), the ACL matrix and token authenticator of
tests/test_meta_acl.py, the event log's rows and MetaScan's shards, and
each package's MetaClient against the other's MetaServer over the wire.

The reference's nondeterminism (random layout seeds, uuid4 sessions and
request ids, time.time() stamps) is pinned in both packages to the same
values with monkeypatch; nothing in either package changes for it."""

import asyncio
import itertools
import json
import logging
import random
import types as pytypes
import uuid

import numpy as np
import pytest

import t3fs.client.meta_client
import t3fs.core.service
import t3fs.kv.engine
import t3fs.meta.acl
import t3fs.meta.auth
import t3fs.meta.events
import t3fs.meta.schema
import t3fs.meta.service
import t3fs.meta.store
import t3fs.mgmtd.types
import t3fs.net.server
import t3fs.utils.serde
import t3fs.utils.status
import t3fs_torch.client.meta_client
import t3fs_torch.core.service
import t3fs_torch.kv.engine
import t3fs_torch.meta.acl
import t3fs_torch.meta.auth
import t3fs_torch.meta.events
import t3fs_torch.meta.schema
import t3fs_torch.meta.service
import t3fs_torch.meta.store
import t3fs_torch.mgmtd.types
import t3fs_torch.net.server
import t3fs_torch.utils.serde
import t3fs_torch.utils.status


def _pkg(root) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, schema=root.meta.schema, store=root.meta.store,
        service=root.meta.service, events=root.meta.events,
        acl=root.meta.acl, auth=root.meta.auth, kv=root.kv.engine,
        core=root.core.service, mgmtd=root.mgmtd.types,
        net=root.net.server, mc=root.client.meta_client,
        serde=root.utils.serde, status=root.utils.status)


REF = _pkg(t3fs)
PORT = _pkg(t3fs_torch)
PKGS = (REF, PORT)


class _Clock:
    """time.time() stand-in: every call moves a quarter second on."""

    def __init__(self):
        self.n = itertools.count()

    def time(self) -> float:
        return 1_700_000_000.0 + 0.25 * next(self.n)


class _Uuid:
    def __init__(self):
        self.n = itertools.count(1)

    def uuid4(self):
        return uuid.UUID(int=next(self.n))


@pytest.fixture
def pin(monkeypatch):
    """-> reset(): pins time, uuid4 and random in both packages' meta
    modules to fresh deterministic sources; call it before each run."""
    def reset():
        clock, ids = _Clock(), _Uuid()
        for p in PKGS:
            for mod in (p.schema, p.store, p.events, p.service):
                monkeypatch.setattr(mod, "time", clock)
            monkeypatch.setattr(p.store, "uuidlib", ids)
            monkeypatch.setattr(p.mc, "uuidlib", ids)
            monkeypatch.setattr(p.store, "random", random.Random(7))
            monkeypatch.setattr(p.mc, "random", random.Random(7))
    return reset


def make_routing(p, num_chains=3):
    r = p.mgmtd.RoutingInfo(version=1)
    for c in range(1, num_chains + 1):
        r.chains[c] = p.mgmtd.ChainInfo(c, 1, [p.mgmtd.ChainTargetInfo(
            c * 100, 1, p.mgmtd.PublicTargetState.SERVING)])
    r.chain_tables[1] = p.mgmtd.ChainTable(1, list(r.chains))
    return r


def make_store(p, event_log=None, stripe=1):
    routing = make_routing(p)
    return p.store.MetaStore(p.kv.MemKVEngine(), p.store.ChainAllocator(
        lambda: routing, default_chunk_size=4096, default_stripe=stripe),
        event_log=event_log)


async def kv_snapshot(p, kv) -> list:
    """Every key and value in kv, in key order."""
    async def fn(txn):
        return await txn.get_range(b"", b"\xff" * 8)
    return await p.kv.with_transaction(kv, fn)


def encode(p, value):
    """An op's outcome as bytes: the serde encoding of its result (tuples
    as lists), or the StatusCode it raised."""
    if isinstance(value, tuple):
        value = list(value)
    return p.serde.dumps(value)


async def outcome(p, coro):
    try:
        return ("ok", encode(p, await coro))
    except p.status.StatusError as e:
        return ("err", int(e.code))


# ---------------------------------------------------------------- structs

def _struct_values(p, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    s, sv = p.schema, p.service

    def u(bits=40):
        return int(rng.integers(0, 1 << bits, dtype=np.uint64))

    def t():
        return float(rng.random() * 2e9)

    lay = p.store.FileLayout(chunk_size=4096 << int(rng.integers(0, 8)),
                             stripe_size=2, chains=[u(16), u(16)], seed=u(16))
    ino = s.Inode(inode_id=u(), itype=s.InodeType.FILE, perm=u(9), uid=u(16),
                  gid=u(16), nlink=u(4), atime=t(), mtime=t(), ctime=t(),
                  layout=lay, length=u(), length_hint=u(), parent=u(),
                  dir_lock=f"c{u(8)}")
    sym = s.Inode(inode_id=u(), itype=s.InodeType.SYMLINK,
                  symlink_target="/a/" + "é" * int(rng.integers(1, 9)))
    user = p.acl.UserInfo(uid=u(16), gids=[u(16), u(16)], token=f"t{u()}",
                          is_admin=bool(rng.integers(0, 2)))
    return {
        "Inode": ino, "Symlink": sym,
        "DirEntry": s.DirEntry(u(), f"name-{u()}", u(), s.InodeType.DIRECTORY),
        "FileSession": s.FileSession(u(), str(uuid.UUID(int=u())), "cl", t()),
        "IdemRecord": s.IdemRecord("cl", f"r{u()}", t(), "create", ino, "x"),
        "UserInfo": user,
        "PathReq": sv.PathReq(path=f"/p/{u()}", follow=False, recursive=True,
                              perm=u(9), chunk_size=u(20), stripe=u(3),
                              client_id="c", request_id=f"r{u()}", write=True,
                              target="/t", unlock=True, flags=2, user=user,
                              rdwr=True),
        "EntryReq": sv.EntryReq(parent=u(), name="n", dparent=u(), dname="d",
                                target="/t", perm=u(9), inode_id=u(),
                                limit=u(8), must_dir=1, flags=1, user=user),
        "InodeReq": sv.InodeReq(inode_id=u(), session_id="s", length=u(),
                                position=u(), user=user),
        "InodeRsp": sv.InodeRsp(inode=ino, session_id="s"),
        "ReaddirRsp": sv.ReaddirRsp(entries=[s.DirEntry(1, "a", u(),
                                                        s.InodeType.FILE)]),
        "BatchStatRsp": sv.BatchStatRsp(inodes=[ino, None, sym]),
        "SetAttrReq": sv.SetAttrReq(inode_id=u(), perm=u(9), uid=-1, gid=u(8),
                                    atime=t(), mtime=-1.0, user=None),
        "ReaddirPlusRsp": sv.ReaddirPlusRsp(
            dir=ino, names=["a", "b"], ids=[u(), u()], types=[1, 2],
            inode_blobs=[p.serde.dumps(sym), b""]),
        "LockDirReq": sv.LockDirReq(inode_id=u(), client_id="c",
                                    action="preempt_lock"),
        "PruneSessionReq": sv.PruneSessionReq(client_id="c",
                                              session_ids=["a", "b"]),
        "keys": [s.Inode.key(u(63)), s.DirEntry.key(u(), "x/é"),
                 s.DirEntry.prefix(u()), s.FileSession.key(u(), "s"),
                 s.FileSession.prefix(u()), s.gc_key(u()),
                 s.idem_key("r", "c"), s.GC_PREFIX, s.IDEM_PREFIX],
    }


STRUCTS = list(_struct_values(REF, 0))


@pytest.mark.parametrize("name", STRUCTS)
def test_meta_struct_bytes_match_reference(name):
    """Each meta struct and wire type encodes to the reference's bytes,
    and each package decodes the other's encoding to an equal value."""
    for seed in range(4):
        ref, port = (_struct_values(p, seed)[name] for p in PKGS)
        if name == "keys":
            assert ref == port
            continue
        rb, pb = REF.serde.dumps(ref), PORT.serde.dumps(port)
        assert rb == pb
        assert PORT.serde.dumps(PORT.serde.loads(rb)) == rb
        assert REF.serde.dumps(REF.serde.loads(pb)) == pb


def test_distributor_owners_match_reference():
    from t3fs.meta.distributor import Distributor as RefD
    from t3fs_torch.meta.distributor import Distributor as PortD
    rng = np.random.default_rng(3)
    servers = [int(x) for x in rng.integers(1, 1000, 7)]
    for me in servers[:3]:
        ref, port = RefD(me, lambda: servers), PortD(me, lambda: servers)
        for key in [int(x) for x in rng.integers(0, 1 << 62, 200)] + \
                ["prune-sessions", "prune-idem", b"\x00\xff"]:
            assert ref.owner(key) == port.owner(key)
            assert ref.is_mine(key) == port.is_mine(key)
    assert PortD(5).servers() == [5] and PortD(5).is_mine("x")


# ------------------------------------------------- the namespace sequence

DIRS = ["/a", "/a/b", "/c", "/c/d/e", "/a/b/g"]
NAMES = ["f0", "f1", "f2", "d0"]


def make_ops(seed: int, n: int = 200) -> list[tuple]:
    """A seeded op list: (kind, raw ints) — paths, inodes and sessions
    are picked at run time by index into what the run has seen, so the
    list is the same for both packages."""
    rng = np.random.default_rng(seed)
    kinds = ["mkdirs", "create", "create", "create_replay", "open", "close",
             "report", "set_length", "rename", "symlink", "set_attr",
             "set_attr_inode", "remove", "readdir", "batch_stat", "lock",
             "hardlink", "stat", "lookup", "readdir_plus", "create_at",
             "unlink_at", "rename_at"]
    return [(kinds[int(rng.integers(len(kinds)))],
             [int(x) for x in rng.integers(0, 1 << 16, 6)])
            for _ in range(n)]


async def run_sequence(p, ops) -> tuple[list, list, list]:
    """-> (outcomes, KV snapshot, event log lines)."""
    lines: list[str] = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger(f"{p.name}.meta.event")
    handler, level = Grab(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        store = make_store(p, event_log=p.events.MetaEventLog())
        out, inodes, sessions, rids = [], [1], [], []

        def path(r, file=True):
            d = DIRS[r % len(DIRS)]
            return f"{d}/{NAMES[(r >> 4) % len(NAMES)]}" if file else d

        async def op(kind, r):
            ino = inodes[r[1] % len(inodes)]
            if kind == "mkdirs":
                return await store.mkdirs(path(r[0], r[1] & 1), perm=0o755,
                                          recursive=bool(r[2] & 1),
                                          client_id="c1",
                                          request_id=f"m{r[3]}")
            if kind in ("create", "create_replay"):
                rid = rids[r[3] % len(rids)] if kind == "create_replay" \
                    and rids else f"r{r[3]}"
                rids.append(rid)
                got = await store.create(path(r[0]), perm=0o640,
                                         chunk_size=4096 * (1 + r[2] % 3),
                                         stripe=1 + r[4] % 2,
                                         session_client="c1" if r[5] & 1
                                         else "", request_id=rid,
                                         want_session=bool(r[2] & 2))
                inodes.append(got[0].inode_id)
                sessions.append((got[0].inode_id, got[1]))
                return got
            if kind == "open":
                got = await store.open_file(path(r[0]), write=bool(r[2] & 1),
                                            session_client="c2")
                sessions.append((got[0].inode_id, got[1]))
                return got
            if kind == "close":
                iid, sid = sessions[r[1] % len(sessions)] if sessions \
                    else (ino, "")
                return await store.close_file(
                    iid, sid, length=r[2] if r[3] & 1 else None)
            if kind == "report":
                return await store.report_write_position(ino, r[2])
            if kind == "set_length":
                return await store.set_length(ino, r[2] % 9000)
            if kind == "rename":
                return await store.rename(path(r[0], r[2] & 1),
                                          path(r[3], r[2] & 1),
                                          client_id="c1",
                                          request_id=f"n{r[4]}",
                                          flags=r[5] % 3)
            if kind == "symlink":
                got = await store.symlink(path(r[0]), path(r[2], r[3] & 1),
                                          client_id="c1")
                inodes.append(got.inode_id)
                return got
            if kind == "set_attr":
                return await store.set_attr(path(r[0]), perm=r[2] & 0o777,
                                            uid=r[3] % 3 if r[4] & 1 else None)
            if kind == "set_attr_inode":
                return await store.set_attr_inode(
                    ino, perm=r[2] & 0o7777, gid=r[3] % 4,
                    mtime=float(r[4]) if r[5] & 1 else None)
            if kind == "remove":
                return await store.remove(path(r[0], r[2] & 1),
                                          recursive=bool(r[3] & 1),
                                          client_id="c1",
                                          request_id=f"x{r[4]}")
            if kind == "readdir":
                return await store.readdir(path(r[0], False),
                                           limit=r[2] % 3)
            if kind == "batch_stat":
                return await store.batch_stat(
                    [path(r[i], r[i] & 2) for i in range(4)],
                    follow=bool(r[4] & 1))
            if kind == "lock":
                return await store.lock_directory(
                    path(r[0], False), owner=f"c{1 + r[2] % 2}",
                    unlock=bool(r[3] & 1))
            if kind == "hardlink":
                return await store.hardlink(path(r[0]), path(r[2]),
                                            client_id="c1")
            if kind == "stat":
                return await store.stat(path(r[0], r[2] & 1),
                                        follow=bool(r[3] & 1))
            if kind == "lookup":
                return await store.lookup(ino, NAMES[r[2] % len(NAMES)])
            if kind == "readdir_plus":
                got = await store.readdir_plus_inode(ino)
                return [got[0], got[1], got[2]]
            if kind == "create_at":
                got = await store.create_at(ino, NAMES[r[2] % len(NAMES)],
                                            session_client="c2",
                                            request_id=f"a{r[3]}")
                inodes.append(got[0].inode_id)
                return got
            if kind == "unlink_at":
                return await store.unlink_at(
                    ino, NAMES[r[2] % len(NAMES)], recursive=bool(r[3] & 1),
                    must_dir=[None, True, False][r[4] % 3])
            if kind == "rename_at":
                return await store.rename_at(
                    ino, NAMES[r[2] % len(NAMES)], inodes[r[3] % len(inodes)],
                    NAMES[r[4] % len(NAMES)], flags=r[5] % 3)
            raise AssertionError(kind)

        for d in DIRS:
            out.append(("setup", await outcome(p, store.mkdirs(d))))
        for kind, r in ops:
            out.append((kind, await outcome(p, op(kind, r))))
        out.append(("sessions", encode(p, await store.scan_sessions())))
        out.append(("gc", encode(p, await store.gc_pop(limit=100))))
        out.append(("inodes", encode(p, await store.list_inodes(limit=10_000))))
        out.append(("paths", [await outcome(p, store.get_real_path(i))
                              for i in inodes]))
        return out, await kv_snapshot(p, store.kv), lines
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_namespace_sequence_matches_reference(seed, pin):
    """~200 seeded namespace ops through each package's MetaStore on its
    own MemKVEngine: every op's result (or StatusCode), every KV key and
    value afterwards, and every event row are equal."""
    ops = make_ops(seed)
    runs = []
    for p in PKGS:
        pin()
        runs.append(asyncio.run(run_sequence(p, ops)))
    (ref_out, ref_kv, ref_ev), (port_out, port_kv, port_ev) = runs
    for i, (a, b) in enumerate(zip(ref_out, port_out)):
        assert a == b, (i, a, b)
    assert len(ref_out) == len(port_out)
    assert ref_kv == port_kv
    assert ref_ev == port_ev
    # the sequence did real work: files, failures and events
    codes = [o[1][0] for o in ref_out[len(DIRS):len(DIRS) + len(ops)]]
    assert codes.count("ok") > 60 and codes.count("err") > 60
    assert len(ref_kv) > 40 and len(ref_ev) > 25


# ------------------------------------------------------------- ACL matrix

def _users(p) -> dict:
    U = p.acl.UserInfo
    return {"ROOT": U(uid=0), "ALICE": U(uid=1000, gids=[1000]),
            "BOB": U(uid=1001, gids=[1001]),
            "CAROL": U(uid=1002, gids=[1000, 1002]),
            "ADMIN": U(uid=5000, is_admin=True), None: None}


def _owned(path, owner, gid, perm):
    """mk_owned of tests/test_meta_acl.py: mkdir + chown, trusted."""
    return [("ok", "mkdirs", (path,), {"perm": perm}),
            ("ok", "set_attr", (path,), {"uid": owner, "gid": gid})]


D, OK = "deny", "ok"
# each scenario is tests/test_meta_acl.py's test of that name, step by
# step: (expected, op, args, kwargs); ("stat", path) args resolve to the
# inode id of path
ACL = {
    "open_modes_enforced": [
        (OK, "mkdirs", ("/home",), {"perm": 0o777}),
        (OK, "create", ("/home/secret",), {"perm": 0o600, "user": "ALICE"}),
        (OK, "open_file", ("/home/secret",), {"user": "ALICE"}),
        (OK, "open_file", ("/home/secret",), {"write": True, "session_client": "c", "user": "ALICE"}),
        (D, "open_file", ("/home/secret",), {"user": "BOB"}),
        (D, "open_file", ("/home/secret",), {"write": True, "session_client": "c", "user": "BOB"}),
        (OK, "open_file", ("/home/secret",), {"write": True, "session_client": "c", "user": "ROOT"}),
        (OK, "create", ("/home/locked",), {"perm": 0o000, "user": "ALICE"}),
        (D, "open_file", ("/home/locked",), {"user": "ALICE"}),
        (OK, "open_file", ("/home/locked",), {"user": "ROOT"})],
    "group_bits": [
        (OK, "mkdirs", ("/g",), {"perm": 0o777}),
        (OK, "create", ("/g/shared",), {"perm": 0o640, "user": "ALICE"}),
        (OK, "open_file", ("/g/shared",), {"user": "CAROL"}),
        (D, "open_file", ("/g/shared",), {"write": True, "session_client": "c", "user": "CAROL"}),
        (D, "open_file", ("/g/shared",), {"user": "BOB"})],
    "traversal_x_required": [
        *_owned("/private", 1000, 1000, 0o700),
        (OK, "create", ("/private/f",), {"perm": 0o644, "user": "ALICE"}),
        (D, "stat", ("/private/f",), {"user": "BOB"}),
        (D, "open_file", ("/private/f",), {"user": "BOB"}),
        (OK, "stat", ("/private/f",), {"user": "ALICE"})],
    "create_unlink_need_parent_write": [
        *_owned("/ro", 1000, 1000, 0o755),
        (D, "create", ("/ro/f",), {"user": "BOB"}),
        (D, "mkdirs", ("/ro/d",), {"user": "BOB"}),
        (D, "symlink", ("/ro/s", "/tmp"), {"user": "BOB"}),
        (OK, "create", ("/ro/f",), {"user": "ALICE"}),
        (D, "remove", ("/ro/f",), {"user": "BOB"}),
        (OK, "remove", ("/ro/f",), {"user": "ALICE"})],
    "readdir_needs_read": [
        *_owned("/lst", 1000, 1000, 0o711),
        (OK, "create", ("/lst/f",), {"perm": 0o644, "user": "ALICE"}),
        (D, "readdir", ("/lst",), {"user": "BOB"}),
        (OK, "open_file", ("/lst/f",), {"user": "BOB"}),
        (OK, "readdir", ("/lst",), {"user": "ALICE"})],
    "chmod_chown_rules": [
        (OK, "mkdirs", ("/o",), {"perm": 0o777}),
        (OK, "create", ("/o/f",), {"perm": 0o644, "user": "ALICE"}),
        (OK, "set_attr", ("/o/f",), {"perm": 0o600, "user": "ALICE"}),
        (D, "set_attr", ("/o/f",), {"perm": 0o777, "user": "BOB"}),
        (D, "set_attr", ("/o/f",), {"uid": 1001, "user": "ALICE"}),
        (OK, "set_attr", ("/o/f",), {"uid": 1001, "user": "ROOT"}),
        (OK, "set_attr", ("/o/f",), {"uid": 1000, "user": "ROOT"}),
        (OK, "set_attr", ("/o/f",), {"gid": 1000, "user": "ALICE"}),
        (D, "set_attr", ("/o/f",), {"gid": 1001, "user": "ALICE"}),
        (OK, "set_attr", ("/o/f",), {"perm": 0o600, "user": "ALICE"}),
        (D, "set_attr_inode", (("stat", "/o/f"),), {"mtime": 1.0, "user": "BOB"}),
        (OK, "set_attr_inode", (("stat", "/o/f"),), {"mtime": 1.0, "user": "ALICE"})],
    "sticky_bit_restricted_deletion": [
        (OK, "mkdirs", ("/tmpdir",), {"perm": 0o1777}),
        (OK, "create", ("/tmpdir/a",), {"perm": 0o644, "user": "ALICE"}),
        (OK, "create", ("/tmpdir/b",), {"perm": 0o644, "user": "BOB"}),
        (D, "remove", ("/tmpdir/a",), {"user": "BOB"}),
        (D, "rename", ("/tmpdir/a", "/tmpdir/stolen"), {"user": "BOB"}),
        (OK, "remove", ("/tmpdir/a",), {"user": "ALICE"}),
        (OK, "remove", ("/tmpdir/b",), {"user": "ROOT"})],
    "rename_needs_both_parents_writable": [
        (OK, "mkdirs", ("/src",), {"perm": 0o777}),
        *_owned("/dst", 1000, 1000, 0o755),
        (OK, "create", ("/src/f",), {"perm": 0o644, "user": "BOB"}),
        (D, "rename", ("/src/f", "/dst/f"), {"user": "BOB"}),
        (OK, "rename", ("/src/f", "/dst/f"), {"user": "ALICE"})],
    "entry_level_ops_enforced": [
        *_owned("/e", 1000, 1000, 0o700),
        (OK, "create", ("/e/f",), {"perm": 0o600, "user": "ALICE"}),
        (D, "lookup", (("stat", "/e"), "f"), {"user": "BOB"}),
        (D, "readdir_inode", (("stat", "/e"),), {"user": "BOB"}),
        (D, "create_at", (("stat", "/e"), "g"), {"user": "BOB"}),
        (D, "open_inode", (("stat", "/e/f"),), {"user": "BOB"}),
        (D, "unlink_at", (("stat", "/e"), "f"), {"user": "BOB"}),
        (OK, "lookup", (("stat", "/e"), "f"), {"user": "ALICE"}),
        (OK, "open_inode", (("stat", "/e/f"),), {"user": "ALICE"}),
        (OK, "create_at", (("stat", "/e"), "g"), {"user": "ALICE"}),
        (OK, "unlink_at", (("stat", "/e"), "g"), {"user": "ALICE"})],
    "new_inode_ownership": [
        (OK, "mkdirs", ("/own",), {"perm": 0o777}),
        (OK, "create", ("/own/f",), {"user": "ALICE"}),
        (OK, "mkdirs", ("/own/d",), {"user": "CAROL"}),
        (OK, "create", ("/own/g",), {})],
    "batch_stat_masks_denied_paths": [
        (OK, "mkdirs", ("/pub",), {"perm": 0o777}),
        *_owned("/priv", 1000, 1000, 0o700),
        (OK, "create", ("/pub/a",), {"user": "ALICE"}),
        (OK, "create", ("/priv/b",), {"user": "ALICE"}),
        (OK, "batch_stat", (["/pub/a", "/priv/b"],), {"user": "BOB"})],
    "admin_identity_bypasses": [
        *_owned("/adm", 1000, 1000, 0o700),
        (OK, "create", ("/adm/f",), {"perm": 0o600, "user": "ALICE"}),
        (OK, "open_file", ("/adm/f",), {"user": "ADMIN"}),
        (OK, "set_attr", ("/adm/f",), {"perm": 0o640, "user": "ADMIN"})],
    "open_rdwr_needs_read_and_write": [
        (OK, "mkdirs", ("/wo",), {"perm": 0o777}),
        (OK, "create", ("/wo/log",), {"perm": 0o200, "user": "ALICE"}),
        (OK, "set_attr", ("/wo/log",), {"gid": 1000, "user": "ALICE"}),
        (OK, "open_file", ("/wo/log",), {"write": True, "session_client": "c", "user": "ALICE"}),
        (D, "open_file", ("/wo/log",), {"write": True, "session_client": "c", "user": "ALICE", "rdwr": True}),
        (D, "open_file", ("/wo/log",), {"user": "ALICE"}),
        (D, "open_inode", (("stat", "/wo/log"),), {"write": True, "session_client": "c", "user": "ALICE", "rdwr": True})],
}


async def run_acl(p, steps) -> list:
    store = make_store(p)
    users = _users(p)
    out = []
    for expect, name, args, kwargs in steps:
        args = [(await store.stat(a[1])).inode_id
                if isinstance(a, tuple) else a for a in args]
        kwargs = dict(kwargs)
        if "user" in kwargs:
            kwargs["user"] = users[kwargs["user"]]
        got = await outcome(p, getattr(store, name)(*args, **kwargs))
        out.append(got)
        if expect == D:
            assert got == ("err", int(p.status.StatusCode.META_NO_PERMISSION)), \
                (name, args)
        else:
            assert got[0] == "ok", (name, args, got)
    return out


async def run_authenticator(p) -> list:
    """test_token_authenticator_blocks_forged_identity and
    test_authenticated_deployment_requires_identity, through MetaService's
    handlers with the token authenticator on a registry KV."""
    U, out = p.acl.UserInfo, []
    store = make_store(p)
    reg_kv = p.kv.MemKVEngine()
    alice = U(uid=1000, token="tok-alice", gids=[1000])

    async def seed(txn):
        txn.set(p.core._user_key(1000), p.serde.dumps(alice))
    await p.kv.with_transaction(reg_kv, seed)
    svc = p.service.MetaServer(store, None, gc_period_s=3600).service
    svc.authenticator = p.auth.make_token_authenticator(reg_kv)
    await store.mkdirs("/home", perm=0o777)
    await store.create("/home/alice.txt", perm=0o600, user=U(uid=1000, gids=[1000]))
    await store.create("/home/bob.txt", perm=0o600, user=U(uid=1001, gids=[1001]))
    deny = ("err", int(p.status.StatusCode.META_NO_PERMISSION))
    for path, user, expect in [
            ("/home/alice.txt", U(uid=1000, token="tok-alice"), OK),
            ("/home/alice.txt", U(uid=1000, token="wrong"), D),
            ("/home/alice.txt", U(uid=4242, token="x"), D),
            ("/home/bob.txt", U(uid=1000, token="tok-alice", is_admin=True,
                                gids=[1001]), D),
            ("/home/alice.txt", None, D)]:
        got = await outcome(p, svc.open(p.service.PathReq(path=path, user=user),
                                        b"", None))
        assert (got == deny) == (expect == D), (path, user, got)
        out.append(got)
    # a second check of the good token is served from the cache
    out.append(await outcome(p, svc.open(p.service.PathReq(
        path="/home/alice.txt", user=U(uid=1000, token="tok-alice")), b"", None)))
    return out


@pytest.mark.parametrize("case", [*ACL, "token_authenticator"])
def test_acl_matrix_matches_reference(case, pin):
    """tests/test_meta_acl.py's scenarios on both packages: each step's
    allow or deny is the reference test's, and the two packages agree on
    every step's result bytes."""
    outs = []
    for p in PKGS:
        pin()
        outs.append(asyncio.run(run_authenticator(p) if case ==
                                "token_authenticator" else run_acl(p, ACL[case])))
    assert outs[0] == outs[1]


# ----------------------------------------------------- events and MetaScan

@pytest.mark.parametrize("shards", [1, 7, 8])
def test_meta_scan_and_event_rows_match_reference(shards, pin, tmp_path):
    """tests/test_meta_events.py's op list emits the same typed events
    and JSON rows in both packages (none for failed ops), MetaScan's
    shard bounds and rows are equal, and the Parquet sinks hold the same
    rows."""
    async def body(p):
        events, lines = [], []
        log = p.events.MetaEventLog()
        orig = log.emit

        def spy(etype, **fields):
            events.append((etype.value, fields))
            orig(etype, **fields)
        log.emit = spy

        class Grab(logging.Handler):
            def emit(self, record):
                lines.append(json.loads(record.getMessage()))
        logger = logging.getLogger(f"{p.name}.meta.event")
        handler, level = Grab(), logger.level
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        try:
            store = make_store(p, event_log=log)
            await store.mkdirs("/a/b")
            inode, _ = await store.create("/a/b/f", session_client="c1",
                                          request_id="r1")
            _, sid = await store.open_file("/a/b/f", write=True,
                                           session_client="c1")
            await store.close_file(inode.inode_id, session_id=sid, length=42)
            await store.close_file(inode.inode_id, length=42)
            await store.symlink("/a/b/link", "f")
            await store.hardlink("/a/b/f", "/a/b/f2")
            await store.rename("/a/b/f2", "/a/b/f3")
            await store.remove("/a/b/f3")
            for bad in (store.remove("/does/not/exist"),
                        store.hardlink("/missing", "/x")):
                with pytest.raises(p.status.StatusError):
                    await bad
            server = p.service.MetaServer(store, None, gc_period_s=3600)
            await store.create("/victim")
            await store.remove("/victim")
            await server.gc_once()
            for i in range(40):
                await store.mkdirs(f"/dir{i:02d}")
                await store.create(f"/dir{i:02d}/file")
            scan = p.events.MetaScan(store.kv, p.events.MetaScanOptions(
                shards=shards, items_per_getrange=9))
            inodes, dirents = await scan.inodes(), await scan.dirents()
            bounds = [p.events._shard_bounds(pre, shards)
                      for pre in (b"INOD", b"DENT")]
            return (events, lines, [p.serde.dumps(x) for x in inodes],
                    [p.serde.dumps(x) for x in dirents], bounds)
        finally:
            logger.removeHandler(handler)
            logger.setLevel(level)

    outs = []
    for p in PKGS:
        pin()
        outs.append(asyncio.run(body(p)))
    ref, port = outs
    assert [e for e, _ in ref[0]][:8] == ["mkdir", "create", "open_write",
                                         "close_write", "symlink", "hardlink",
                                         "rename", "remove"]
    assert "gc" in [e for e, _ in ref[0]]
    assert len(ref[3]) == 84          # 80 dirents + /a, /a/b, /a/b/{f,link}
    for a, b in zip(ref, port):
        assert a == b
    # the Parquet sink: one pinned event through each package's log, and
    # either package's reader sees the same row in the other's file
    pytest.importorskip("pyarrow")
    from t3fs.analytics.trace_log import read_trace as ref_read
    from t3fs_torch.analytics.trace_log import read_trace as port_read
    rows = []
    for p in PKGS:
        pin()
        path = str(tmp_path / f"{p.name}-{shards}.parquet")
        log = p.events.MetaEventLog(path)
        log.emit(p.events.MetaEventType.MKDIR, inode_id=7, entry_name="/d")
        log.close()
        rows.append((list(ref_read(path)), list(port_read(path))))
    assert rows[0][0] == rows[0][1] == rows[1][0] == rows[1][1]
    assert [r["entry_name"] for r in rows[0][0]] == ["/d"]


# -------------------------------------------------------------- the wire

async def run_wire(client_pkg, server_pkg) -> tuple[list, list]:
    """One MetaClient of client_pkg against a MetaServer of server_pkg on
    its own RPC server: every typed op, then the server's KV."""
    sp, cp = server_pkg, client_pkg
    store = make_store(sp)
    server = sp.service.MetaServer(store, None, gc_period_s=3600)
    rpc = sp.net.Server()
    for svc in server.services:
        rpc.add_service(svc)
    await rpc.start()
    mc = cp.mc.MetaClient([rpc.address], client_id="mc-wire")
    out = []
    try:
        async def o(coro):
            out.append(await outcome(cp, coro))
        await o(mc.mkdirs("/w/x"))
        await o(mc.create("/w/x/f", chunk_size=8192, write=True))
        f = await mc.stat("/w/x/f")
        await o(mc.report_write_position(f.inode_id, 5000))
        await o(mc.close(f.inode_id, "", length=6000))
        await o(mc.open("/w/x/f", write=True))
        await o(mc.stat("/w/x/f"))
        await o(mc.stat_inode(f.inode_id))
        await o(mc.readdir("/w/x"))
        await o(mc.symlink("/w/link", "/w/x/f"))
        await o(mc.hardlink("/w/x/f", "/w/h"))
        await o(mc.rename("/w/h", "/w/h2"))
        await o(mc.rename("/w/h2", "/w/link", flags=1))
        await o(mc.set_attr("/w/x/f", 0o600))
        await o(mc.set_attr_inode(f.inode_id, gid=7, mtime=123.5))
        await o(mc.batch_stat(["/w/x/f", "/nope", "/w/link"]))
        await o(mc.batch_stat_inodes([f.inode_id, 1, 99999]))
        d = await mc.stat("/w/x")
        await o(mc.lookup(d.inode_id, "f"))
        await o(mc.readdir_plus(d.inode_id))
        await o(mc.readdir_inode(1))
        await o(mc.create_at(d.inode_id, "g", write=True))
        await o(mc.mkdir_at(d.inode_id, "sub"))
        await o(mc.symlink_at(d.inode_id, "s", "g"))
        await o(mc.link_at(f.inode_id, d.inode_id, "f-link"))
        await o(mc.rename_at(d.inode_id, "g", d.inode_id, "g2"))
        await o(mc.rename_at(d.inode_id, "g2", d.inode_id, "s", flags=2))
        await o(mc.unlink_at(d.inode_id, "s", must_dir=False))
        await o(mc.open_inode(f.inode_id, write=True))
        await o(mc.lock_directory("/w/x"))
        await o(mc.lock_directory_inode(d.inode_id, "unlock"))
        await o(mc.get_real_path(d.inode_id))
        await o(mc.truncate(f.inode_id, 100))
        await o(mc.sync(f.inode_id))
        await o(mc.prune_sessions())
        await o(mc.remove("/w/x", recursive=False))
        await o(mc.remove("/w", recursive=True))
        await o(mc.stat("/w/x/f"))
        return out, await kv_snapshot(sp, store.kv)
    finally:
        await mc.close_conn()
        await rpc.stop()


WIRE = [(c, s) for c in ("ref", "port") for s in ("ref", "port")]


@pytest.mark.parametrize("client,server", WIRE)
def test_meta_client_server_wire_matches_reference(client, server, pin):
    """Each package's MetaClient against each package's MetaServer: the
    results the client decodes and the server's KV afterwards equal the
    reference client against the reference server."""
    by = {"ref": REF, "port": PORT}
    pin()
    want = asyncio.run(run_wire(REF, REF))
    pin()
    got = asyncio.run(run_wire(by[client], by[server]))
    assert [o[0] for o in want[0]].count("ok") > 30
    for i, (a, b) in enumerate(zip(want[0], got[0])):
        assert a == b, (i, a, b)
    assert want[1] == got[1]
