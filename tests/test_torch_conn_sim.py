"""The port's connection simulator (t3fs_torch.testing.conn_sim, over the
port's net.conn.Connection) against the JAX package's: every case of
tests/test_conn_sim.py run on the port, then each case's schedules run in
both packages seed by seed with the same counters and the same bytes
delivered on each link in the same order, and one SimPair with one end
from each package.  The wire's clock and request ids are pinned in both
packages with monkeypatch; nothing in either package changes for it.

Connection state-machine schedules (specs/RDMASocket analog).

Each test is one family of deterministic schedules over the REAL
Connection code; seeds make failures reproducible."""

import asyncio
import itertools

import pytest

from t3fs_torch.testing.conn_sim import SimPair, run_schedule


def run(coro):
    return asyncio.run(coro)


def test_arbitrary_segmentation_delivers_all_frames():
    """C4: duplex calls complete intact under 1..1M-byte delivery chunks."""
    async def body():
        for seed in range(8):
            r = await run_schedule(seed, calls=16)
            assert r["ok"] == 32 and r["err"] == 0, (seed, r)
            assert r["payload_ok"], seed
    run(body())


def test_cut_mid_stream_fails_pending_cleanly():
    """C3: a reset mid-schedule errors every unfinished call, hangs none,
    leaks nothing."""
    async def body():
        saw_err = False
        for seed in range(8):
            r = await run_schedule(seed, calls=16, cut_after=5)
            assert r["ok"] + r["err"] == 32, (seed, r)
            saw_err |= r["err"] > 0
        assert saw_err, "cut schedules never produced an error?"
    run(body())


def test_corruption_closes_and_fails_cleanly():
    """A flipped bit in flight must surface as clean connection failure
    (header CRC / frame error), never a hang or a wrong payload."""
    async def body():
        for seed in range(8):
            r = await run_schedule(seed, calls=12, corrupt_after=3)
            assert r["ok"] + r["err"] == 24, (seed, r)
            # only the single flipped frame may pass (payload region is
            # app-checksummed, not wire-checksummed); envelope corruption
            # always fails closed
            assert r["bad_payloads"] <= 1, (seed, r)
    run(body())


def test_corruption_of_compressed_frames():
    """Same corruption family with compression on: zlib-level damage must
    also fail closed (FrameError path), not deliver garbage."""
    async def body():
        for seed in range(6):
            r = await run_schedule(seed, calls=10, corrupt_after=4,
                                   compress_threshold=64)
            assert r["ok"] + r["err"] == 20, (seed, r)
            # zlib streams detect most damage; at worst the one frame leaks
            assert r["bad_payloads"] <= 1, (seed, r)
    run(body())


def test_close_during_inflight_handler():
    """close() racing a dispatched handler: reply write fails benignly,
    waiters error, nothing leaks."""
    async def body():
        started = asyncio.Event()
        release = asyncio.Event()

        async def slow(body_, payload, conn):
            started.set()
            await release.wait()
            return None, b"late"

        pair = SimPair({"Sim.slow": slow}, {})
        call = asyncio.create_task(pair.b.call("Sim.slow", None, timeout=5.0))
        # deliver the request, let the handler start
        for _ in range(200):
            pair.ba.pump(1 << 20)
            await asyncio.sleep(0)
            if started.is_set():
                break
        assert started.is_set()
        await pair.a.close()               # close under the handler
        release.set()
        with pytest.raises(Exception):
            await call
        await pair.settle()
        await pair.close()
        pair.check_quiesced()
    run(body())


def test_timeout_then_late_response_ignored():
    """A response landing after the caller timed out must be dropped
    without touching a new call's waiter or crashing the read loop."""
    async def body():
        async def slow(body_, payload, conn):
            return None, b"slow-reply"

        pair = SimPair({"Sim.slow": slow}, {})
        # issue with a tiny timeout and DON'T pump: caller times out
        with pytest.raises(Exception):
            await pair.b.call("Sim.slow", None, timeout=0.05)
        # now deliver the stale request + its response end-to-end
        await pair.settle()
        # a fresh call on the same conn still works
        async def echo(body_, payload, conn):
            return None, payload
        pair.a.dispatcher["Sim.echo"] = echo
        _, pay = await asyncio.wait_for(
            _call_with_pump(pair, "Sim.echo", b"fresh"), 5.0)
        assert pay == b"fresh"
        await pair.close()
        pair.check_quiesced()
    run(body())


async def _call_with_pump(pair, method, payload):
    task = asyncio.create_task(pair.b.call(method, None, payload=payload,
                                           timeout=5.0))
    while not task.done():
        pair.ba.pump(1 << 20)
        pair.ab.pump(1 << 20)
        await asyncio.sleep(0)
    return task.result()


# ---- the port against the reference, seed by seed ----

from t3fs.net.conn import Connection as RefConnection       # noqa: E402
from t3fs.testing import conn_sim as ref_sim                # noqa: E402
from t3fs_torch.net.conn import Connection as PortConnection  # noqa: E402
from t3fs_torch.testing import conn_sim as port_sim         # noqa: E402

# the schedules a seed reproduces: a compressed frame is inflated in a
# worker thread, so with compression on a schedule varies run to run in
# either package (those cases are held to the same invariants below)
CASES = {
    "segmentation": dict(calls=16),
    "cut": dict(calls=16, cut_after=5),
    "corrupt": dict(calls=12, corrupt_after=3),
    "late_cut": dict(calls=8, cut_after=40),
}
COMPRESSED = {
    "compressed": dict(calls=10, compress_threshold=64),
    "corrupt_compressed": dict(calls=10, corrupt_after=4,
                               compress_threshold=64),
}


class _Clock:
    """time.time pinned: the wire's call and server stamps are equal in
    both packages."""

    @staticmethod
    def time() -> float:
        return 1.0e9


def _delivered(module, monkeypatch) -> list:
    """Every pump that moved bytes, as (link, bytes), in order; the
    package's wire clock pinned."""
    pkg = module.__name__.split(".")[0]
    for name in ("conn", "wire"):
        monkeypatch.setattr(f"{pkg}.net.{name}.time", _Clock)
    log = []
    orig = module.SimLink.pump

    def pump(self, n):
        before = bytes(self.writer.outbox[:n])
        moved = orig(self, n)
        if moved:
            log.append((self.writer.name, before[:moved]))
        return moved
    monkeypatch.setattr(module.SimLink, "pump", pump)
    return log


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedules_equal_across_packages(case, monkeypatch):
    ref_log = _delivered(ref_sim, monkeypatch)
    port_log = _delivered(port_sim, monkeypatch)
    for seed in range(6):
        ref_log.clear()
        port_log.clear()
        # request ids come from one counter a process: start both at 1
        monkeypatch.setattr(RefConnection, "_uuid_counter", itertools.count(1))
        monkeypatch.setattr(PortConnection, "_uuid_counter", itertools.count(1))
        ref = run(ref_sim.run_schedule(seed, **CASES[case]))
        port = run(port_sim.run_schedule(seed, **CASES[case]))
        assert ref == port, (case, seed, ref, port)
        assert ref_log == port_log and ref_log, (case, seed)


@pytest.mark.parametrize("case", sorted(COMPRESSED))
def test_compressed_schedules_hold_in_both_packages(case):
    """Every call resolves, nothing leaks (run_schedule's quiesce checks)
    and at most the one corrupted frame slips through, in both packages."""
    kw = COMPRESSED[case]
    for seed in range(6):
        for module in (ref_sim, port_sim):
            r = run(module.run_schedule(seed, **kw))
            assert r["ok"] + r["err"] == 2 * kw["calls"], (module, seed, r)
            assert r["bad_payloads"] <= (1 if "corrupt_after" in kw else 0)


def test_sim_pair_across_packages():
    """One end from each package over the port's scheduled links: echo
    calls both ways at 1..4096-byte payloads, delivered in random-sized
    pieces, all answered with their own bytes; then a clean close."""
    async def body():
        import random

        rng = random.Random(7)

        async def echo(body_, payload, conn):
            return body_, payload

        ra, rb = asyncio.StreamReader(), asyncio.StreamReader()
        wa, wb = port_sim.SimWriter("a->b"), port_sim.SimWriter("b->a")
        wa.peer_reader, wb.peer_reader = rb, ra
        ab, ba = port_sim.SimLink(wa, rb), port_sim.SimLink(wb, ra)
        a = PortConnection(ra, wa, {"Sim.echo": echo}, name="port")
        b = RefConnection(rb, wb, {"Sim.echo": echo}, name="ref")
        a.start()
        b.start()
        payloads = [bytes([i]) * rng.randint(1, 4096) for i in range(24)]
        tasks = [asyncio.create_task(conn.call("Sim.echo", None, payload=p,
                                               timeout=5.0))
                 for conn in (a, b) for p in payloads]
        while any(not t.done() for t in tasks):
            (ab if rng.random() < 0.5 else ba).pump(
                rng.choice([1, 7, 64, 1024, 1 << 20]))
            await asyncio.sleep(0)
        got = [t.result()[1] for t in tasks]
        assert got == payloads + payloads
        await a.close()
        await b.close()
        for _ in range(20):
            await asyncio.sleep(0)
        for conn in (a, b):
            assert not conn._waiters
    run(body())
